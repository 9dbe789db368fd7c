"""The port's elastic trainer over N ``gloo`` ranks on the CPU, against the
JAX ``ElasticTrainer`` on N forced host devices.

The JAX runs happen in one subprocess with 8 forced host devices (XLA reads
the flag before JAX starts, as ``tests/test_runtime_elastic.py``'s
``run_with_devices`` does), started when this module's first test starts,
so that it runs while the port's ranks do. Both packages start from one
checkpoint of the JAX ``init_state(PRNGKey(0))``, written here at step 0.

Scenarios (all reduced configs, float32, ``model_size`` 1):

* (a) JAX's resize scenario (``tests/test_runtime_elastic.py:30``): deepseek-7b,
  ZeRO-1, batch 8 x 16, start on 8 -> 3 steps -> resize to 4 -> 2 -> resize
  to 8 -> 2; the seven losses against JAX's;
* (b) the same fresh run from ``seed`` on one device (in this process) and
  on 4 ranks: losses, and the checkpoints of both after 3 steps (deepseek-7b
  at 8 layers of width 8, where ZeRO-1 cuts leaves along the repeat dim);
* (c) restart after failure (``:59``): qwen2-7b, 4 ranks train 2 steps and
  checkpoint; a new trainer on 2 ranks resumes at step 2, and step 3's loss
  equals JAX's unbroken run's and the port's on one device;
* (d) mesh rounding: 6 devices at batch 8 train on 4 (``devices == 4``),
  and each rank holds the ZeRO-1 cut of m, v and master that the port's
  ``zero1_specs`` names;
* (e) the MoE's groups: qwen3-moe-30b-a3b at capacity factor 1.0 (experts
  drop pairs, so the token groups change the loss) on 2 ranks against JAX
  on 2 devices, with microbatch 0 and 2 (which pins the rows each rank
  takes);
* (f) int8 gradients with ZeRO-1 on 2 ranks against one device, then
  across a resize (2 -> 4 ranks), a port checkpoint that JAX restores and
  steps on;
* failures: a rank that raises fails the call with its traceback, a rank
  that dies fails it with its exit code, within seconds.

Tolerances: the losses at ``test_torch_training.TOLS``' loss tolerance of
the variant (1e-5 float32, 1e-5 int8): sums over ranks and over another
framework add in another order; measured differences are below 1e-6. The
checkpoints of (b): params 1e-4 (``TOLS``' float32 params tolerance), m and
v 1e-4 relative to each leaf's norm.
"""
import dataclasses
import json
import os
import shutil
import signal
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
from repro_torch.checkpoint import checkpointer as ckpt  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.model import CausalLM  # noqa: E402
from repro_torch.runtime.elastic import ElasticTrainer, _mesh_from_devices  # noqa: E402
from repro_torch.sharding import partitioning as pt  # noqa: E402
from test_torch_training import TOLS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = TOLS["float32"][0]
INT8_LOSS_TOL = TOLS["int8"][0]
PARAMS_TOL = TOLS["float32"][2]
MOMENTS_RTOL = TOLS["float32"][4]


def _drop(cfg):
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))


CONFIGS = {  # name -> (arch, config change)
    "deepseek": ("deepseek-7b", None),
    "qwen2": ("qwen2-7b", None),
    "moe": ("qwen3-moe-30b-a3b", _drop),
}


def _cfgs(name):
    arch, change = CONFIGS[name]
    jcfg, tcfg = JC.reduced_config(JC.ARCHS[arch]), TC.reduced_config(TC.get_config(arch))
    return (change(jcfg), change(tcfg)) if change else (jcfg, tcfg)


# the JAX runs: each scenario from a copy of its config's initial checkpoint
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

def cfg_of(name):
    arch = {{"deepseek": "deepseek-7b", "qwen2": "qwen2-7b", "moe": "qwen3-moe-30b-a3b"}}[name]
    cfg = reduced_config(ARCHS[arch])
    if name == "moe":
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    return cfg

def trainer(scenario, name, batch, **kw):
    d = os.path.join(work, scenario)
    shutil.copytree(os.path.join(init, name), d)
    return ElasticTrainer(cfg_of(name), TrainConfig(**kw), global_batch=batch, seq_len=16,
                          ckpt_dir=d, model_size=1)

out = {{}}
t = trainer("resize", "deepseek", 8, zero1=True)
t.start(devs[:8])
losses = [t.train_steps(1)["loss"] for _ in range(3)]
t.resize(devs[:4])
losses += [t.train_steps(1)["loss"] for _ in range(2)]
t.resize(devs[:8])
losses += [t.train_steps(1)["loss"] for _ in range(2)]
out["resize"] = {{"losses": losses, "devices": [m["devices"] for m in t.metrics_log]}}
t = trainer("unbroken", "qwen2", 4)
t.start(devs[:4])
out["unbroken"] = [t.train_steps(1)["loss"] for _ in range(3)]
for mb in (0, 2):
    t = trainer(f"moe{{mb}}", "moe", 4, microbatch=mb)
    t.start(devs[:2])
    out[f"moe{{mb}}"] = [t.train_steps(1)["loss"] for _ in range(3)]
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


def _from_init(init_dir, name, path):
    shutil.copytree(init_dir / name, path)
    return str(path)


def _trainer(cfg, ckpt_dir, batch, **kw):
    data_fn = kw.pop("data_fn", None)
    return ElasticTrainer(cfg, TrainConfig(**kw), global_batch=batch, seq_len=16,
                          ckpt_dir=str(ckpt_dir), data_fn=data_fn, init_device="cpu")


def _losses(trainer, n):
    return [trainer.train_steps(1)["loss"] for _ in range(n)]


def _close(a, b, tol):
    return max(abs(x - y) for x, y in zip(a, b)) <= tol and len(a) == len(b)


# ------------------------------------------------------------ (b), (d)

@pytest.fixture(scope="module")
def four_of_six(tmp_path_factory):
    """deepseek-7b, reduced and then made deep and narrow (8 layers of width
    8, so that ZeRO-1 cuts some leaves along the repeat dim), from seed 0 on
    ["cpu"] * 6 at batch 8 (4 ranks) and on one device: 3 steps each, then a
    checkpoint of each."""
    cfg = TC.reduced_config(TC.get_config("deepseek-7b")).with_(num_layers=8, d_model=8)
    root = tmp_path_factory.mktemp("four_of_six")
    data_fn = SyntheticLM(cfg, seed=0).data_fn
    ranks = _trainer(cfg, root / "ranks", 8, data_fn=data_fn)
    one = _trainer(cfg, root / "one", 8, data_fn=data_fn)
    try:
        ranks.start(["cpu"] * 6)
        one.start(["cpu"])
        out = {"ranks": _losses(ranks, 3), "one": _losses(one, 3),
               "mesh": ranks.mesh.shape, "devices": ranks.metrics_log[-1]["devices"],
               "opt_shapes": ranks.opt_shapes(), "cfg": cfg}
        ranks.checkpoint()
        one.checkpoint()
    finally:
        ranks.close()
    out["leaves"] = [ckpt.restore(str(root / d)) for d in ("ranks", "one")]
    return out


def test_mesh_rounds_to_a_divisor_of_the_global_batch(four_of_six):
    assert four_of_six["mesh"] == {"data": 4, "model": 1}
    assert four_of_six["devices"] == 4
    for n, batch, dp in [(6, 8, 4), (7, 8, 4), (3, 8, 2), (5, 4, 4), (8, 8, 8), (1, 8, 1),
                         (8, 6, 6)]:
        assert _mesh_from_devices(["cpu"] * n, 1, batch).shape == {"data": dp, "model": 1}


def test_sharding_does_not_change_the_math(four_of_six):
    assert _close(four_of_six["ranks"], four_of_six["one"], LOSS_TOL), four_of_six
    ranks, one = four_of_six["leaves"]
    assert list(ranks) == list(one)
    assert int(ranks[".opt/.step"]) == int(one[".opt/.step"]) == 3
    for k in ranks:
        a, b = ranks[k].double(), one[k].double()
        assert a.shape == b.shape, k
        if k.startswith((".params/", ".opt/.master/")):
            assert (a - b).abs().max() <= PARAMS_TOL, k
        elif k.startswith((".opt/.m/", ".opt/.v/")):
            assert (a - b).norm() <= MOMENTS_RTOL * max(b.norm(), 1e-30), k


def test_ranks_hold_the_zero1_cuts(four_of_six):
    cfg = four_of_six["cfg"]
    model = CausalLM(cfg, device="meta")
    tree = pt.param_shape_tree(model)
    mesh = four_of_six["mesh"]

    class Shape:
        shape = mesh
    specs = pt.zero1_specs(pt.param_specs(tree, cfg, Shape), tree, Shape)
    want = {}
    for path, shape in tree.items():
        d = pt.data_dim(specs[path])
        rest = shape[:d] + shape[d + 1:] if d is not None else shape
        want[path.replace("/", ".")] = ((shape[d] // 4,) + rest) if d is not None else shape
    # norm scales [8, 8] and kernels [8, 8, 64] are cut along the repeat dim:
    # two whole layers a rank
    assert pt.data_dim(specs["repeats/b0/pre_norm/scale"]) == 0
    assert pt.data_dim(specs["repeats/b0/mixer/wq/kernel"]) == 0
    assert four_of_six["opt_shapes"] == [want] * 4
    # every leaf that can be cut is: m, v and master are a quarter of a copy
    whole = sum(int(np.prod(s)) for s in tree.values())
    held = sum(int(np.prod(s)) for s in want.values())
    assert held < whole / 2


# ------------------------------------------------------------------ (a)

def test_resize_8_4_8_matches_jax(tmp_path, init_dir, jax_runs):
    _, cfg = _cfgs("deepseek")
    t = _trainer(cfg, _from_init(init_dir, "deepseek", tmp_path / "ck"), 8, zero1=True)
    try:
        t.start(["cpu"] * 8)
        losses = _losses(t, 3)
        t.resize(["cpu"] * 4)
        losses += _losses(t, 2)
        t.resize(["cpu"] * 8)
        losses += _losses(t, 2)
    finally:
        t.close()
    assert t.step == 7 and t.resizes == 2
    assert [m["devices"] for m in t.metrics_log] == [8, 8, 8, 4, 4, 8, 8]
    want = jax_runs.result()["resize"]
    assert want["devices"] == [8, 8, 8, 4, 4, 8, 8]
    assert _close(losses, want["losses"], LOSS_TOL), (losses, want["losses"])
    assert all(np.isfinite(losses))


# ------------------------------------------------------------------ (c)

def test_restart_on_fewer_ranks_resumes_from_the_checkpoint(tmp_path, init_dir, jax_runs):
    _, cfg = _cfgs("qwen2")
    d = _from_init(init_dir, "qwen2", tmp_path / "ck")
    first = _trainer(cfg, d, 4)
    try:
        first.start(["cpu"] * 4)
        first.train_steps(2)
        first.checkpoint()
    finally:
        first.close()
    again = _trainer(cfg, d, 4)                  # "node failure": two devices lost
    try:
        again.start(["cpu"] * 2)
        assert again.step == 2
        m = again.train_steps(1)
    finally:
        again.close()
    assert m["step"] == 3 and m["devices"] == 2
    one = _trainer(cfg, _from_init(init_dir, "qwen2", tmp_path / "one"), 4)
    one.start(["cpu"])
    unbroken = _losses(one, 3)
    assert abs(m["loss"] - unbroken[2]) <= LOSS_TOL, (m, unbroken)
    assert abs(m["loss"] - jax_runs.result()["unbroken"][2]) <= LOSS_TOL


# ------------------------------------------------------------------ (e)

@pytest.mark.parametrize("microbatch", [0, 2])
def test_moe_groups_follow_the_data_extent(tmp_path, init_dir, jax_runs, microbatch):
    _, cfg = _cfgs("moe")
    t = _trainer(cfg, _from_init(init_dir, "moe", tmp_path / "ck"), 4, microbatch=microbatch)
    try:
        t.start(["cpu"] * 2)
        losses = _losses(t, 3)
    finally:
        t.close()
    want = jax_runs.result()[f"moe{microbatch}"]
    assert _close(losses, want, LOSS_TOL), (losses, want)


@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_step_takes_moe_groups(microbatch):
    """``make_train_step(moe_groups=2)`` in one process against the JAX
    step's argument: the same losses over 2 steps, and (capacity factor
    1.0, so experts drop pairs) other losses than one group gives."""
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro_torch import convert
    from repro_torch.training import train_step as TS
    jcfg, cfg = _cfgs("moe")
    init = jax.device_get(JS.init_state(jax.random.PRNGKey(0), jcfg))
    jdata, data = JSyntheticLM(jcfg, seed=0), SyntheticLM(cfg, seed=0)
    jstep = jax.jit(JS.make_train_step(jcfg, JTrainConfig(microbatch=microbatch), moe_groups=2))
    jstate, want = init, []
    for i in range(2):
        jstate, m = jstep(jstate, jdata.batch(i, 4, 16))
        want.append(float(m["loss"]))
    got = {}
    for groups in (1, 2):
        state = convert.state_from_jax(init, cfg, "cpu")
        step = TS.make_train_step(cfg, TrainConfig(microbatch=microbatch), moe_groups=groups)
        got[groups] = []
        for i in range(2):
            state, m = step(state, data.batch(i, 4, 16))
            got[groups].append(float(m["loss"]))
    assert _close(got[2], want, LOSS_TOL), (got, want)
    assert abs(got[1][0] - got[2][0]) > 10 * LOSS_TOL, got


# ------------------------------------------------------------------ (f)

def test_zero1_int8_across_a_resize_matches_one_device_and_restores_into_jax(
        tmp_path, init_dir):
    """int8 gradients, ZeRO-1: 2 ranks take 2 steps (against one device
    from the same checkpoint), resize to 4 ranks, take one more and
    checkpoint; JAX restores that checkpoint, and its next step's loss is
    the port's."""
    jcfg, cfg = _cfgs("qwen2")
    one = _trainer(cfg, _from_init(init_dir, "qwen2", tmp_path / "one"), 4,
                   grad_compression="int8")
    one.start(["cpu"])
    alone = _losses(one, 2)
    d = _from_init(init_dir, "qwen2", tmp_path / "ck")
    t = _trainer(cfg, d, 4, grad_compression="int8", zero1=True)
    try:
        t.start(["cpu"] * 2)
        ranks = _losses(t, 2)
        t.resize(["cpu"] * 4)
        t.train_steps(1)
        t.checkpoint()
        want = t.train_steps(1)
    finally:
        t.close()
    assert _close(ranks, alone, INT8_LOSS_TOL), (ranks, alone)
    target = jax.eval_shape(lambda k: JS.init_state(k, jcfg), jax.random.PRNGKey(0))
    state = jckpt.restore(d, target, step=3)
    rng = np.random.default_rng(0 * 1_000_003 + 3)        # the trainers' batch of step 3
    toks = rng.integers(0, jcfg.vocab_size, (4, 16), dtype=np.int32)
    batch = {"tokens": jax.numpy.asarray(toks),
             "labels": jax.numpy.asarray(np.roll(toks, -1, axis=1))}
    step = jax.jit(JS.make_train_step(jcfg, JTrainConfig(grad_compression="int8")))
    _, m = step(state, batch)
    assert int(state.opt.step) == 3
    assert abs(float(m["loss"]) - want["loss"]) <= INT8_LOSS_TOL, (m, want)


# ------------------------------------------------------------- failures

def test_a_rank_that_raises_fails_the_call_with_its_traceback(tmp_path):
    """Token ids past the vocabulary (data drawn for another config) raise
    in the embedding on every rank."""
    cfg = TC.reduced_config(TC.get_config("qwen2-7b"))
    wrong = SyntheticLM(cfg.with_(vocab_size=10 ** 6), seed=0).data_fn
    t = _trainer(cfg, tmp_path, 4, data_fn=wrong)
    try:
        t.start(["cpu"] * 2)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match=r"rank \d failed:\n(.|\n)*IndexError"):
            t.train_steps(1)
        assert time.monotonic() - t0 < 60
        assert all(not p.is_alive() for p in t._world.procs)
    finally:
        t.close()


def test_a_rank_that_dies_fails_the_call(tmp_path):
    cfg = TC.reduced_config(TC.get_config("qwen2-7b"))
    t = _trainer(cfg, tmp_path, 4)
    try:
        t.start(["cpu"] * 2)
        t.train_steps(1)
        victim = t._world.procs[1]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(timeout=30)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match=r"rank 1 (exited with code -9|closed its pipe)"):
            t.train_steps(1)
        assert time.monotonic() - t0 < 60
        assert all(not p.is_alive() for p in t._world.procs)
    finally:
        t.close()


def test_devices_are_named_once_and_of_one_type():
    with pytest.raises(ValueError, match="named twice"):
        make_mesh((2, 1), ("data", "model"), ["cuda:0", "cuda"])
    with pytest.raises(ValueError, match="one device type"):
        make_mesh((2, 1), ("data", "model"), ["cpu", "cuda:0"])
    with pytest.raises(RuntimeError, match="needs 4 devices; 3 given"):
        make_mesh((4, 1), ("data", "model"), ["cpu"] * 3)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 5)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert mesh.group("data") is None                     # no world: no collective


def test_launcher_trains_on_cpu_ranks(tmp_path, capsys):
    argv = ["--reduced", "--arch", "qwen2-7b", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--ckpt-dir", str(tmp_path / "ck")]
    assert launcher.main(argv + ["--devices", "2", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "arch=qwen2-7b devices=2 start_step=0" in out and "step 2: loss=" in out
    assert launcher.main(argv + ["--devices", "0", "--steps", "3",
                                 "--log", str(tmp_path / "log.json")]) == 0
    out = capsys.readouterr().out
    assert "arch=qwen2-7b devices=1 start_step=2" in out
    assert json.load(open(tmp_path / "log.json"))[-1]["step"] == 3
    assert not os.path.exists(tmp_path / "ck" / ".ranks")
