"""The port's two training examples (``repro_torch.examples.quickstart``,
``repro_torch.examples.train_100m``) against the JAX package's
(``examples/quickstart.py``, ``examples/train_100m.py``) on the CPU, from
the same weights: the JAX example's initial state, converted as
``test_torch_training`` converts it (quickstart) or restored from the JAX
package's checkpoint, which both examples resume from (train_100m).
Tolerance: 1e-4 on the losses (quickstart's as printed, to 4 decimals: a
difference below 1e-5 prints at most one unit of the last place apart; the
gradient norm to its printed 3 decimals), 1e-4 on train_100m's logged
losses; the same exit codes; and train_100m resumes from the checkpoint it
wrote, as the JAX example does."""
import dataclasses
import importlib.util
import json
import re
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.examples import quickstart, train_100m  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _steps(out):
    pat = re.compile(r"step (\d+): loss=(\S+) nll=(\S+) gnorm=(\S+)")
    return [tuple(float(x) for x in m.groups()) for m in map(pat.search, out.splitlines()) if m]


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-moe-30b-a3b"])
def test_quickstart_prints_the_jax_examples_losses(capsys, arch):
    argv = ["--arch", arch, "--steps", "3"]
    assert _jax_example("quickstart").main(argv) == 0
    want = capsys.readouterr().out
    jstate = JS.init_state(jax.random.PRNGKey(0), JC.reduced_config(JC.ARCHS[arch]))
    state = convert.state_from_jax(jax.device_get(jstate),
                                   TC.reduced_config(TC.get_config(arch)), "cpu")
    assert quickstart.main(argv + ["--device", "cpu"], state=state) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]        # arch and parameter count
    w, g = _steps(want), _steps(got)
    assert len(w) == len(g) == 3
    for (ws, wl, wn, wg), (gs, gl, gn, gg) in zip(w, g):
        assert ws == gs and abs(wl - gl) <= TOL + 1e-9 and abs(wn - gn) <= TOL + 1e-9
        assert abs(wg - gg) <= 1e-3 + 1e-9


def test_train_100m_matches_jax_and_resumes_from_its_checkpoint(tmp_path, capsys):
    jax_ex = _jax_example("train_100m")
    cfg = train_100m.config("10m")
    jcfg = JC.ARCHS["deepseek-7b"].with_(param_dtype="float32", compute_dtype="float32",
                                         **jax_ex.PRESETS["10m"])
    assert train_100m.PRESETS == jax_ex.PRESETS
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jckpt.save(str(tmp_path / "jax"), JS.init_state(jax.random.PRNGKey(0), jcfg), step=0)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    base = ["--preset", "10m", "--batch", "2", "--seq", "32"]
    for steps in (3, 2):                       # the second run resumes from the first's end
        jlog, tlog = tmp_path / f"jax{steps}.json", tmp_path / f"port{steps}.json"
        rc_j = jax_ex.main(base + ["--steps", str(steps), "--ckpt-dir", str(tmp_path / "jax"),
                                   "--log", str(jlog)])
        want = capsys.readouterr().out
        rc_t = train_100m.main(base + ["--steps", str(steps), "--device", "cpu",
                                       "--ckpt-dir", str(tmp_path / "port"),
                                       "--log", str(tlog)])
        got = capsys.readouterr().out
        assert rc_t == rc_j
        resumed = f"resumed from step {0 if steps == 3 else 3}"
        assert resumed in want and resumed in got
        assert got.splitlines()[0] == want.splitlines()[0]
        w, g = json.loads(jlog.read_text()), json.loads(tlog.read_text())
        assert [r["step"] for r in g] == [r["step"] for r in w]
        for a, b in zip(w, g):
            for k in ("loss", "nll"):
                assert abs(a[k] - b[k]) <= TOL, (k, a, b)
            assert abs(a["grad_norm"] - b["grad_norm"]) <= TOL * max(1.0, a["grad_norm"])

