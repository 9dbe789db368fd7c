"""Checkpoints, the elastic trainer and the train launcher of the port, on the
CPU.

A checkpoint is the JAX package's directory layout (``step_XXXXXXXXXX/``,
``manifest.json``, one ``.npy`` per leaf, bfloat16 as raw bytes, ``LATEST``),
so a JAX ``TrainState`` saved by ``repro.checkpoint.checkpointer`` restores
into the port and a port state restores into the JAX package. Leaves come
back bit for bit; one more step after a restore matches the other package's
at the float32 training tolerance of ``test_torch_training`` (1e-5).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckpt  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.runtime.elastic import ElasticTrainer  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

ARCH = "recurrentgemma-2b"
B, S = 2, 24
TOL = 1e-5


@pytest.fixture(scope="module")
def cfgs():
    return JC.reduced_config(JC.ARCHS[ARCH]), TC.reduced_config(TC.get_config(ARCH))


@pytest.fixture(scope="module")
def jax_run(cfgs):
    """A JAX state after two steps and the metrics of its third."""
    jcfg, _ = cfgs
    step = jax.jit(JS.make_train_step(jcfg, JTrainConfig()))
    data = JSyntheticLM(jcfg, seed=0)
    state = JS.init_state(jax.random.PRNGKey(0), jcfg)
    for i in range(2):
        state, _ = step(state, data.batch(i, B, S))
    _, m = step(state, data.batch(2, B, S))
    return jax.device_get(state), {k: float(v) for k, v in m.items()}


def _port_step(tcfg, state, i):
    state, m = TS.make_train_step(tcfg, TrainConfig())(state, SyntheticLM(tcfg).batch(i, B, S))
    return state, {k: float(v) for k, v in m.items()}


def test_jax_checkpoint_restores_into_the_port(tmp_path, cfgs, jax_run):
    _, tcfg = cfgs
    state2, want = jax_run
    jckpt.save(str(tmp_path), state2, step=2)
    assert ckpt.latest_step(str(tmp_path)) == 2
    leaves = ckpt.restore(str(tmp_path))
    state = convert.state_from_leaves(leaves, tcfg, "cpu")
    assert int(state.opt.step) == 2
    back = convert.state_to_jax(state)
    for name in ("m", "v", "master"):
        jax.tree.map(np.testing.assert_array_equal, back["opt"][name],
                     getattr(state2.opt, name))
    jax.tree.map(np.testing.assert_array_equal, back["params"], state2.params)
    _, got = _port_step(tcfg, state, 2)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL * max(1.0, abs(want[k])), (k, got, want)


def test_port_checkpoint_restores_into_jax(tmp_path, cfgs, jax_run):
    jcfg, tcfg = cfgs
    state2, want = jax_run
    port = convert.state_from_jax(state2, tcfg, "cpu")
    path = ckpt.save(str(tmp_path), convert.state_leaves(port), step=2)
    keys = [m["key"] for m in json.load(open(os.path.join(path, "manifest.json")))["leaves"]]
    jax_dir = tmp_path / "jax"
    jpath = jckpt.save(str(jax_dir), state2, step=2)
    jkeys = [m["key"] for m in json.load(open(os.path.join(jpath, "manifest.json")))["leaves"]]
    assert keys == jkeys                               # same leaves, same order
    assert sorted(os.listdir(path)) == sorted(os.listdir(jpath))
    target = jax.eval_shape(lambda k: JS.init_state(k, jcfg), jax.random.PRNGKey(0))
    restored = jckpt.restore(str(tmp_path), target)
    jax.tree.map(np.testing.assert_array_equal, jax.device_get(restored), state2)
    step = jax.jit(JS.make_train_step(jcfg, JTrainConfig()))
    _, m = step(restored, JSyntheticLM(jcfg, seed=0).batch(2, B, S))
    assert {k: float(v) for k, v in m.items()} == want


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_musicgen_checkpoints_round_trip_both_ways(tmp_path, direction):
    """Reduced musicgen-large after one JAX step: its codebook head ([d, 4V])
    and its unused embedding table, with their moments, cross in either
    direction bit for bit, and the next step on the other side gives the
    JAX step's metrics (the port's at the float32 tolerance)."""
    jcfg = JC.reduced_config(JC.ARCHS["musicgen-large"])
    tcfg = TC.reduced_config(TC.get_config("musicgen-large"))
    step = jax.jit(JS.make_train_step(jcfg, JTrainConfig()))
    data = JSyntheticLM(jcfg, seed=0)
    state, _ = step(JS.init_state(jax.random.PRNGKey(0), jcfg), data.batch(0, B, S))
    _, m = step(state, data.batch(1, B, S))
    state, want = jax.device_get(state), {k: float(v) for k, v in m.items()}
    assert state.params["head"]["kernel"].shape == (64, 4 * 256)
    if direction == "jax_to_port":
        jckpt.save(str(tmp_path), state, step=1)
        port = convert.state_from_leaves(ckpt.restore(str(tmp_path)), tcfg, "cpu")
        back = convert.state_to_jax(port)
        jax.tree.map(np.testing.assert_array_equal, back["params"], state.params)
        for name in ("m", "v", "master"):
            jax.tree.map(np.testing.assert_array_equal, back["opt"][name],
                         getattr(state.opt, name))
        _, got = _port_step(tcfg, port, 1)
        for k in want:
            assert abs(got[k] - want[k]) <= TOL * max(1.0, abs(want[k])), (k, got, want)
    else:
        port = convert.state_from_jax(state, tcfg, "cpu")
        ckpt.save(str(tmp_path), convert.state_leaves(port), step=1)
        target = jax.eval_shape(lambda k: JS.init_state(k, jcfg), jax.random.PRNGKey(0))
        restored = jckpt.restore(str(tmp_path), target)
        jax.tree.map(np.testing.assert_array_equal, jax.device_get(restored), state)
        _, m = step(restored, data.batch(1, B, S))
        assert {k: float(v) for k, v in m.items()} == want


def test_launcher_trains_musicgen(tmp_path, capsys):
    """``--reduced --arch musicgen-large`` trains on the CPU from
    ``SyntheticLM``'s embeddings and codebook labels: finite losses, and a
    checkpoint whose head has four codebooks' columns."""
    assert launcher.main(["--reduced", "--arch", "musicgen-large", "--device", "cpu",
                          "--batch", "2", "--seq", "16", "--steps", "2",
                          "--ckpt-dir", str(tmp_path / "ck"),
                          "--log", str(tmp_path / "log.json")]) == 0
    assert "arch=musicgen-large devices=1 start_step=0" in capsys.readouterr().out
    log = json.load(open(tmp_path / "log.json"))
    assert [m["step"] for m in log] == [2] and np.isfinite(log[-1]["loss"])
    leaves = ckpt.restore(str(tmp_path / "ck"))
    assert leaves[".params/head/kernel"].shape == (64, 4 * 256)


def test_save_restore_round_trip_bf16_and_async(tmp_path):
    """bfloat16 leaves are stored as raw bytes and come back bit for bit;
    ``AsyncCheckpointer`` writes the same files from a worker thread and
    ``LATEST`` names its step; ``restore`` with a target casts and checks."""
    cfg = TC.reduced_config(TC.get_config(ARCH)).with_(param_dtype="bfloat16",
                                                       compute_dtype="bfloat16")
    state = TS.init_state(cfg, seed=3, device="cpu")
    leaves = convert.state_leaves(state)
    assert leaves[".params/embed/table"].dtype == torch.bfloat16
    ckpt.save(str(tmp_path / "sync"), leaves, step=5)
    manifest = json.load(open(tmp_path / "sync" / "step_0000000005" / "manifest.json"))
    meta = {m["key"]: m for m in manifest["leaves"]}
    assert meta[".params/embed/table"]["dtype"] == "bfloat16"
    assert meta[".opt/.step"] == {"key": ".opt/.step", "file": ".opt_.step.npy",
                                  "shape": [], "dtype": "int32"}
    back = ckpt.restore(str(tmp_path / "sync"))
    assert list(back) == list(leaves)
    for k, t in leaves.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    writer = ckpt.AsyncCheckpointer(str(tmp_path / "async"))
    writer.save(leaves, step=5)
    writer.save(leaves, step=6)
    writer.close()
    assert ckpt.latest_step(str(tmp_path / "async")) == 6
    for step in (5, 6):
        got = ckpt.restore(str(tmp_path / "async"), step=step)
        assert all(torch.equal(got[k], t) for k, t in leaves.items())
    target = {".opt/.m/embed/table": torch.empty(256, 64, dtype=torch.float64)}
    assert ckpt.restore(str(tmp_path / "sync"), target)[".opt/.m/embed/table"].dtype \
        == torch.float64
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path / "sync"), {".opt/.m/embed/table": torch.empty(2)})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path / "sync"), {".params/nope": torch.empty(2)})
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def _trainer(cfg, ckpt_dir):
    return ElasticTrainer(cfg, TrainConfig(), global_batch=B, seq_len=S,
                          ckpt_dir=str(ckpt_dir), data_fn=SyntheticLM(cfg, seed=0).data_fn)


def test_elastic_resize_continues_with_the_same_losses(tmp_path, cfgs):
    _, tcfg = cfgs
    plain = _trainer(tcfg, tmp_path / "plain")
    plain.start(["cpu"])
    plain.train_steps(2)
    want = plain.train_steps(2)
    elastic = _trainer(tcfg, tmp_path / "elastic")
    elastic.start(["cpu"])
    elastic.train_steps(2)
    elastic.resize(["cpu"])
    assert elastic.resizes == 1 and elastic.step == 2
    assert ckpt.latest_step(str(tmp_path / "elastic")) == 2
    got = elastic.train_steps(2)
    assert got == want
    assert [m["step"] for m in elastic.metrics_log] == [2, 4]
    assert set(got) == {"loss", "nll", "grad_norm", "step", "devices"}
    # a restart from the checkpoint picks up at its step
    again = _trainer(tcfg, tmp_path / "elastic")
    again.start(["cpu"])
    assert again.step == 2


def test_elastic_trainer_takes_one_device(tmp_path, cfgs):
    """What is still refused: a model split over devices (``model_size`` > 1,
    tensor parallelism: ROADMAP.md queue 1 item 4b). Two CPU devices train
    as two data-parallel ranks, from the one-device trainer's checkpoint, and
    the next step's loss is the one-device trainer's."""
    _, tcfg = cfgs
    trainer = ElasticTrainer(tcfg, TrainConfig(), global_batch=B, seq_len=S,
                             ckpt_dir=str(tmp_path / "tp"), model_size=2)
    with pytest.raises(NotImplementedError, match="queue 1 item 4b"):
        trainer.start(["cpu", "cpu"])
    one = _trainer(tcfg, tmp_path / "one")
    one.start(["cpu"])
    one.train_steps(1)
    one.checkpoint()
    two = _trainer(tcfg, tmp_path / "one")
    try:
        two.start(["cpu", "cpu"])
        assert two.step == 1 and two.mesh.shape == {"data": 2, "model": 1}
        got = two.train_steps(1)
    finally:
        two.close()
    want = one.train_steps(1)
    assert got["devices"] == 2 and want["devices"] == 1
    assert abs(got["loss"] - want["loss"]) <= TOL, (got, want)


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--reduced", "--arch", ARCH, "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path / "ck")]
    assert launcher.main(argv + ["--steps", "4", "--ckpt-every", "2"]) == 0
    first = capsys.readouterr().out
    assert "start_step=0" in first and "step 2: loss=" in first and "step 4: loss=" in first
    assert launcher.main(argv + ["--steps", "6", "--log", str(tmp_path / "log.json")]) == 0
    second = capsys.readouterr().out
    assert f"arch={ARCH} devices=1 start_step=4" in second
    assert f"done; checkpoint at {tmp_path / 'ck'}" in second
    resumed = json.load(open(tmp_path / "log.json"))
    assert [m["step"] for m in resumed] == [6]
    assert launcher.main(argv[:-1] + [str(tmp_path / "ck2"), "--steps", "6",
                                      "--log", str(tmp_path / "log2.json")]) == 0
    straight = json.load(open(tmp_path / "log2.json"))
    assert straight[-1] == resumed[-1]
    with pytest.raises(NotImplementedError, match="queue 1 item 4b"):
        launcher.main(argv + ["--model-size", "2"])


def test_launcher_trains_the_moe_arch(tmp_path, capsys):
    """``--reduced --arch qwen3-moe-30b-a3b`` trains on the CPU: finite losses
    that include the routers' auxiliary losses (loss - nll above the z-loss
    term alone)."""
    assert launcher.main(["--reduced", "--arch", "qwen3-moe-30b-a3b", "--device", "cpu",
                          "--batch", "2", "--seq", "16", "--steps", "2",
                          "--ckpt-dir", str(tmp_path / "ck"),
                          "--log", str(tmp_path / "log.json")]) == 0
    assert "arch=qwen3-moe-30b-a3b devices=1 start_step=0" in capsys.readouterr().out
    log = json.load(open(tmp_path / "log.json"))
    assert [m["step"] for m in log] == [2]
    m = log[-1]
    assert np.isfinite(m["loss"]) and m["loss"] - m["nll"] > 0.01
