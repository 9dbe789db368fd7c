"""Tensor parallelism over the ``model`` axis: the port's elastic trainer on
N ``gloo`` CPU ranks of a data × model mesh against the JAX
``ElasticTrainer`` on forced host devices (GSPMD), and each parallel layer
on 2 and 4 spawned ranks against its unsplit self.

The JAX runs happen in one subprocess with 8 forced host devices, started
when this module's first test starts, so that it runs while the port's
ranks do. Both packages start from one checkpoint of the JAX
``init_state(PRNGKey(0))`` of each config, written here at step 0, and
draw the same batches (the trainers' default random tokens, batch 8 x 16).

Scenarios (reduced configs, float32):

* (a) JAX's resize scenario (``tests/test_runtime_elastic.py:30``):
  deepseek-7b, ZeRO-1, ``model_size=2``, 8 -> 4 -> 8 ranks as 4x2 -> 2x2 ->
  4x2, 3 + 2 + 2 steps; the seven losses;
* (b) qwen2-7b at ``model_size=4`` on 4 ranks (``wk``/``wv`` hold 2 kv
  heads of 16, cut into four blocks of 8 columns: inside a head), and
  recurrentgemma-2b at ``model_size=2`` on 2 ranks (RG-LRU channels,
  row-parallel gates, the tied vocab-cut head, the logit softcap); 3 steps;
* (c) qwen3-moe-30b-a3b with ``expert_parallel=True`` on 2x2 at capacity
  factor 1.0 (experts drop pairs, so the groups show); 3 steps;
* (d) ``sequence_parallel`` on and off: deepseek-7b at 2x2 (the norms'
  gradients are all-reduced over the model group) and xlstm-1.3b at 1x2
  (the gather around the replicated mixers); 3 steps each;
* (e) checkpoints: (a)'s 4x2 checkpoint at step 7 restored on one device
  in this process and in the JAX package, and JAX's own 4x2 checkpoint at
  step 7 restored on 2x2; the next step's loss of each equals JAX's;
* (f) ``python -m repro_torch.launch.train --model-size 2`` on 4 CPU ranks,
  and ``--model-size 2`` on one device refused with both counts named.

Layers (``tp_layer_ranks``): column- and row-parallel ``Dense`` (the row
one also with a whole input and a sequence-cut output), the vocab-parallel
``Embedding`` and its ``unembed``, and the vocab-parallel cross-entropy, on
2 and 4 ranks.

Tolerances: the losses at ``test_torch_training.TOLS``' float32 loss
tolerance, 1e-5: sums over ranks and over another framework add in another
order (the differences measured are below 1e-6, xlstm-1.3b's excepted: its
gradient norm at 5e-4 relative to JAX's and 1e-4 relative to the port's on
one device; see its test). Layers: 1e-5 relative to
each output's largest magnitude (``tp_layer_ranks.RTOL``).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.runtime.elastic import ElasticTrainer  # noqa: E402
from test_torch_training import TOLS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = TOLS["float32"][0]
XLSTM_NORM_RTOL = 1e-4
XLSTM_JAX_NORM_RTOL = 5e-4
BATCH, SEQ = 8, 16


def _ep(cfg):
    return cfg.with_(moe=dataclasses.replace(cfg.moe, expert_parallel=True,
                                             capacity_factor=1.0))


CONFIGS = {  # name -> (arch, config change)
    "deepseek": ("deepseek-7b", None),
    "qwen2": ("qwen2-7b", None),
    "rg": ("recurrentgemma-2b", None),
    "moe": ("qwen3-moe-30b-a3b", _ep),
    "xlstm": ("xlstm-1.3b", None),
}


def _cfgs(name):
    arch, change = CONFIGS[name]
    jcfg, tcfg = JC.reduced_config(JC.ARCHS[arch]), TC.reduced_config(TC.get_config(arch))
    return (change(jcfg), change(tcfg)) if change else (jcfg, tcfg)


# the JAX runs: each from a copy of its config's initial checkpoint
_JAX_SCRIPT = """
import dataclasses, json, os, shutil, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import jax
from repro.configs import ARCHS, reduced_config
from repro.configs.base import TrainConfig
from repro.runtime.elastic import ElasticTrainer

init, work = {init!r}, {work!r}
devs = jax.devices()
ARCH = {{"deepseek": "deepseek-7b", "qwen2": "qwen2-7b", "rg": "recurrentgemma-2b",
        "moe": "qwen3-moe-30b-a3b", "xlstm": "xlstm-1.3b"}}

def cfg_of(name):
    cfg = reduced_config(ARCHS[ARCH[name]])
    if name == "moe":
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, expert_parallel=True,
                                                capacity_factor=1.0))
    return cfg

def trainer(scenario, name, model_size, **kw):
    d = os.path.join(work, scenario)
    shutil.copytree(os.path.join(init, name), d)
    return ElasticTrainer(cfg_of(name), TrainConfig(**kw), global_batch=8, seq_len=16,
                          ckpt_dir=d, model_size=model_size)

def steps(t, n):
    return [t.train_steps(1)["loss"] for _ in range(n)]

out = {{}}
t = trainer("resize", "deepseek", 2, zero1=True)
t.start(devs[:8])
losses = steps(t, 3)
t.resize(devs[:4])
losses += steps(t, 2)
t.resize(devs[:8])
losses += steps(t, 2)
t.checkpoint()
out["resize"] = {{"losses": losses, "devices": [m["devices"] for m in t.metrics_log],
                 "ckpt": t.ckpt_dir, "next": steps(t, 1)[0]}}
for name, n, ms, kw in [("qwen2", 4, 4, {{}}), ("rg", 2, 2, {{}}), ("moe", 4, 2, {{}}),
                        ("deepseek", 4, 2, {{"sequence_parallel": True}}),
                        ("xlstm", 2, 2, {{"sequence_parallel": True}})]:
    key = name + ("_sp" if kw else "")
    t = trainer(key, name, ms, **kw)
    t.start(devs[:n])
    ms = [t.train_steps(1) for _ in range(1 if name == "xlstm" else 3)]
    out[key] = {{"losses": [m["loss"] for m in ms], "mesh": dict(t.mesh.shape),
                "grad_norms": [m["grad_norm"] for m in ms]}}
print("JAX_RUNS " + json.dumps(out))
"""


class JaxRuns:
    """The JAX subprocess; ``result()`` waits for its losses."""

    def __init__(self, init_dir, work_dir):
        code = _JAX_SCRIPT.format(src=os.path.join(REPO, "src"), init=str(init_dir),
                                  work=str(work_dir))
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, env=env)
        self._out = None

    def result(self):
        if self._out is None:
            try:
                out, err = self.proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                raise
            assert self.proc.returncode == 0, err[-4000:]
            line = [ln for ln in out.splitlines() if ln.startswith("JAX_RUNS ")][-1]
            self._out = json.loads(line[len("JAX_RUNS "):])
        return self._out


@pytest.fixture(scope="module")
def init_dir(tmp_path_factory):
    """One step-0 checkpoint of the JAX initial state per config."""
    root = tmp_path_factory.mktemp("init")
    for name in CONFIGS:
        jcfg, _ = _cfgs(name)
        jckpt.save(str(root / name), JS.init_state(jax.random.PRNGKey(0), jcfg), step=0)
    return root


@pytest.fixture(scope="module", autouse=True)
def jax_runs(init_dir, tmp_path_factory):
    runs = JaxRuns(init_dir, tmp_path_factory.mktemp("jax"))
    yield runs
    if runs.proc.poll() is None:
        runs.proc.kill()
        runs.proc.communicate()


def _trainer(name, ckpt_dir, model_size, **kw):
    _, cfg = _cfgs(name)
    return ElasticTrainer(cfg, TrainConfig(**kw), global_batch=BATCH, seq_len=SEQ,
                          ckpt_dir=str(ckpt_dir), model_size=model_size, init_device="cpu")


def _from_init(init_dir, name, path):
    shutil.copytree(init_dir / name, path)
    return path


def _steps(trainer, n):
    return [trainer.train_steps(1)["loss"] for _ in range(n)]


def _run(init_dir, path, name, n, model_size, steps=3, **kw):
    """``steps`` losses of ``name`` on ``n`` CPU ranks at ``model_size``,
    from the JAX initial checkpoint; and the mesh."""
    t = _trainer(name, _from_init(init_dir, name, path), model_size, **kw)
    try:
        t.start(["cpu"] * n)
        return _steps(t, steps), t.mesh.shape
    finally:
        t.close()


class _Shape:
    """A mesh's shape alone, which the sharding rules read."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


def _close(a, b, tol=LOSS_TOL):
    return len(a) == len(b) and max(abs(x - y) for x, y in zip(a, b)) <= tol


# ------------------------------------------------------------------ (a)

@pytest.fixture(scope="module")
def resize_run(init_dir, tmp_path_factory):
    """(a): 4x2 -> 2x2 -> 4x2, then a checkpoint at step 7."""
    d = _from_init(init_dir, "deepseek", tmp_path_factory.mktemp("resize") / "ck")
    t = _trainer("deepseek", d, 2, zero1=True)
    meshes = []
    try:
        t.start(["cpu"] * 8)
        meshes.append(dict(t.mesh.shape))
        losses = _steps(t, 3)
        t.resize(["cpu"] * 4)
        meshes.append(dict(t.mesh.shape))
        losses += _steps(t, 2)
        t.resize(["cpu"] * 8)
        meshes.append(dict(t.mesh.shape))
        losses += _steps(t, 2)
        t.checkpoint()
        nxt = t.train_steps(1)["loss"]
    finally:
        t.close()
    return {"losses": losses, "meshes": meshes, "resizes": t.resizes, "ckpt": d, "next": nxt,
            "devices": [m["devices"] for m in t.metrics_log][:7]}


def test_resize_4x2_2x2_4x2_matches_jax(resize_run, jax_runs):
    assert resize_run["meshes"] == [{"data": 4, "model": 2}, {"data": 2, "model": 2},
                                    {"data": 4, "model": 2}]
    assert resize_run["resizes"] == 2
    want = jax_runs.result()["resize"]
    assert resize_run["devices"] == want["devices"] == [8, 8, 8, 4, 4, 8, 8]
    assert _close(resize_run["losses"], want["losses"]), (resize_run["losses"], want)
    assert abs(resize_run["next"] - want["next"]) <= LOSS_TOL


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("name,n,model_size", [("qwen2", 4, 4), ("rg", 2, 2)])
def test_model_cut_matches_jax(tmp_path, init_dir, jax_runs, name, n, model_size):
    losses, mesh = _run(init_dir, tmp_path / "ck", name, n, model_size)
    want = jax_runs.result()[name]
    assert mesh == want["mesh"] == {"data": n // model_size, "model": model_size}
    assert _close(losses, want["losses"]), (losses, want)


def test_qwen2_kv_projection_is_cut_inside_a_head():
    """At model 4 reduced qwen2-7b's ``wk`` [64, 32] is cut into blocks of 8
    columns: half of one 16-wide kv head a rank (the case the attention
    gathers), while ``wq`` is cut on head boundaries."""
    from repro_torch import convert
    _, cfg = _cfgs("qwen2")
    specs = convert.param_specs(cfg, _Shape(1, 4))
    assert specs["repeats.b0.mixer.wk.kernel"] == (None, None, "model")
    assert cfg.kv_dim // 4 < cfg.head_dim and cfg.num_heads % 4 == 0


def _peak_bytes(fn):
    """``fn()`` and the most host bytes its allocations held at once: the
    profiler's allocations and frees, op by op in order."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        out = fn()
    held = peak = 0
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        held += e.self_cpu_memory_usage
        peak = max(peak, held)
    return out, peak


@pytest.mark.parametrize("name,data,model", [("qwen2", 1, 4), ("moe", 2, 2)])
def test_fresh_rank_draws_its_cut_a_part_at_a_time(name, data, model):
    """A fresh rank of a data × model mesh (``init_model(mp=...)``) holds
    the cut of ``init_model``'s whole weights, bit for bit, and never the
    whole model: its peak allocation stays under its cut plus twice the
    largest part (the part drawn whole and its float32 draw), at 8 layers
    well under the whole model's bytes."""
    from repro_torch.models.model import jax_leaf
    from repro_torch.sharding import partitioning as pt
    from repro_torch.training.train_step import init_model
    _, cfg = _cfgs(name)
    cfg = cfg.with_(num_layers=8)
    whole = init_model(cfg, seed=0, device="cpu")
    nbytes = lambda ps: sum(p.numel() * p.element_size() for p in ps)  # noqa: E731
    part = max(nbytes(m.parameters()) for m in [whole.embed, *whole.layers]
               + ([whole.head] if whole.head is not None else []))
    for rank in range(data * model):
        mp = pt.ModelParallel(size=model, rank=rank % model, data_size=data,
                              data_rank=rank // model)
        cut, peak = _peak_bytes(lambda: init_model(cfg, seed=0, device="cpu", mp=mp))
        specs = pt.param_specs(pt.param_shape_tree(whole), cfg, mp)
        for n, p in whole.named_parameters():
            key, r = jax_leaf(n, cfg)
            want = pt.local_cut(p, pt.layer_spec(specs[key.replace(".", "/")], r is not None),
                                mp.coords(), mp)
            assert torch.equal(cut.get_parameter(n), want), n
        share = nbytes(cut.parameters())
        assert share < nbytes(whole.parameters()) / 2
        assert peak <= share + 2 * part < nbytes(whole.parameters()), (peak, share, part)


# ------------------------------------------------------------------ (c)

def test_expert_parallel_moe_matches_jax(tmp_path, init_dir, jax_runs):
    losses, mesh = _run(init_dir, tmp_path / "ck", "moe", 4, 2)
    want = jax_runs.result()["moe"]
    assert mesh == want["mesh"] == {"data": 2, "model": 2}
    assert _close(losses, want["losses"]), (losses, want)


def test_expert_leaves_are_cut_over_data_and_model():
    """Each rank of a 2x2 mesh holds 4 of the 8 experts and half of each
    expert's ffn width: [E/2, D, F/2] for ``wi_gate``."""
    from repro_torch import convert
    from repro_torch.models.model import CausalLM
    from repro_torch.sharding import partitioning as pt
    _, cfg = _cfgs("moe")
    specs = convert.param_specs(cfg, _Shape(2, 2))
    assert specs["repeats.b0.moe.wi_gate"] == (None, "data", None, "model")
    mp = pt.ModelParallel(size=2, rank=1, data_size=2, data_rank=1)
    model = CausalLM(cfg, device="cpu", mp=mp)
    m = cfg.moe
    assert tuple(model.layers[0].moe.wi_gate.shape) == (m.num_experts // 2, cfg.d_model,
                                                        m.d_ff_expert // 2)
    assert tuple(model.layers[0].moe.router.kernel.shape) == (cfg.d_model, m.num_experts)


# ------------------------------------------------------------------ (d)

def test_sequence_parallel_deepseek_matches_off_and_jax(tmp_path, init_dir, jax_runs):
    on, mesh = _run(init_dir, tmp_path / "on", "deepseek", 4, 2, sequence_parallel=True)
    off, _ = _run(init_dir, tmp_path / "off", "deepseek", 4, 2)
    assert mesh == {"data": 2, "model": 2}
    assert _close(on, off), (on, off)
    assert _close(on, jax_runs.result()["deepseek_sp"]["losses"])


def test_sequence_parallel_xlstm_matches_off_and_jax(tmp_path, init_dir, jax_runs):
    """The replicated mLSTM/sLSTM mixers under sequence parallelism: the
    seq-cut residual is gathered around each mixer and cut again. One step
    at 1x2, on and off, against JAX's 1x2 step with sequence parallelism:
    the loss at 1e-5, and the gradient norm, which the backward pass sets,
    at 5e-4 relative (``XLSTM_JAX_NORM_RTOL``: the port's norm differs from
    JAX's by 1.3e-4 relative already on one device; a gradient summed over
    the model group, twice the mixers' share, would miss it by far). The
    norm is also held to the port's own on one device at 1e-4 relative
    (``XLSTM_NORM_RTOL``: between layouts it moves by up to 1.4e-5
    relative, measured on ``SyntheticLM``'s batch). Later steps are not
    compared: this reduced xLSTM's gradient norm is near 400 (clipped to
    1), so AdamW's first update follows the sign of each gradient entry,
    and float32 rounding that moves with the layout flips the sign of the
    entries near 0: from this checkpoint the port's 1x2 runs differ from
    its one-device run by 2.2e-4 at step 2 and 1.5e-2 at step 3 (each
    layout the same bits run to run)."""
    got = {}
    for sp, n in ((True, 2), (False, 2), (False, 1)):
        t = _trainer("xlstm", _from_init(init_dir, "xlstm", tmp_path / f"{sp}{n}"), n,
                     sequence_parallel=sp)
        try:
            t.start(["cpu"] * n)
            assert t.mesh.shape == {"data": 1, "model": n}
            got[sp, n] = t.train_steps(1)
        finally:
            t.close()
    want = jax_runs.result()["xlstm_sp"]
    one = got.pop((False, 1))
    jnorm = want["grad_norms"][0]
    for m in got.values():
        assert abs(m["loss"] - want["losses"][0]) <= LOSS_TOL, (got, want)
        assert abs(m["grad_norm"] - jnorm) <= XLSTM_JAX_NORM_RTOL * jnorm, (got, want)
        assert abs(m["grad_norm"] - one["grad_norm"]) <= XLSTM_NORM_RTOL * one["grad_norm"], (
            got, one)


# ------------------------------------------------------------------ (e)

def _jax_next_loss(ckpt_dir, step):
    """JAX restores ``ckpt_dir`` at ``step`` on one device and takes the
    trainers' batch of that step."""
    jcfg, _ = _cfgs("deepseek")
    target = jax.eval_shape(lambda k: JS.init_state(k, jcfg), jax.random.PRNGKey(0))
    state = jckpt.restore(str(ckpt_dir), target, step=step)
    rng = np.random.default_rng(0 * 1_000_003 + step)
    toks = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
    batch = {"tokens": jax.numpy.asarray(toks),
             "labels": jax.numpy.asarray(np.roll(toks, -1, axis=1))}
    _, m = jax.jit(JS.make_train_step(jcfg, JTrainConfig(zero1=True)))(state, batch)
    assert int(state.opt.step) == step
    return float(m["loss"])


def test_4x2_checkpoint_restores_on_one_device_and_in_jax(tmp_path, resize_run, jax_runs):
    d = tmp_path / "ck"
    shutil.copytree(resize_run["ckpt"], d)
    one = _trainer("deepseek", d, 1, zero1=True)
    one.start(["cpu"])
    assert one.step == 7 and one.mesh.size == 1
    got = one.train_steps(1)["loss"]
    want = jax_runs.result()["resize"]["next"]
    assert abs(got - want) <= LOSS_TOL, (got, want)
    assert abs(got - resize_run["next"]) <= LOSS_TOL
    assert abs(_jax_next_loss(resize_run["ckpt"], 7) - want) <= LOSS_TOL


def test_jax_4x2_checkpoint_restores_on_2x2(tmp_path, jax_runs):
    runs = jax_runs.result()["resize"]
    d = tmp_path / "ck"
    shutil.copytree(runs["ckpt"], d)
    t = _trainer("deepseek", d, 2, zero1=True)
    try:
        t.start(["cpu"] * 4)
        assert t.step == 7 and t.mesh.shape == {"data": 2, "model": 2}
        got = t.train_steps(1)["loss"]
    finally:
        t.close()
    assert abs(got - runs["next"]) <= LOSS_TOL, (got, runs["next"])


# ------------------------------------------------------------------ (f)

def test_launcher_takes_model_size(tmp_path, capsys):
    argv = ["--reduced", "--arch", "deepseek-7b", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--steps", "2", "--model-size", "2"]
    assert launcher.main(argv + ["--devices", "4", "--ckpt-dir", str(tmp_path / "a")]) == 0
    out = capsys.readouterr().out
    assert "arch=deepseek-7b devices=4 start_step=0" in out and "step 2: loss=" in out
    with pytest.raises(ValueError, match="1 device.*model_size 2"):
        launcher.main(argv + ["--devices", "1", "--ckpt-dir", str(tmp_path / "b")])


# --------------------------------------------------------------- layers

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["column", "row", "embedding", "cross_entropy"])
def test_parallel_layer_matches_its_unsplit_self(name, n, tmp_path):
    """Each rank of a 1 x n mesh checks ``name`` against its unsplit self,
    forward and gradients (``tp_layer_ranks.main``); a rank that fails
    exits non-zero, and a world that does not finish in 120 s fails."""
    import tp_layer_ranks
    from repro_torch.runtime.elastic import process_context
    ctx = process_context()
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=tp_layer_ranks.main, args=(r, n, store, name))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 120
    try:
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
