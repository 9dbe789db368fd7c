"""The port stands alone: it imports neither JAX nor the JAX package, and it
never falls back to the CPU when the card is asked for and missing. With both
blocked it serves, trains (``python -m repro_torch.launch.train --reduced
--device cpu --steps 2``), runs the campaign, gates its own traced
``mix_tiny`` against the goldens with its own trace CLI, and runs the paper
experiment."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.MULTILINE)

_BLOCKED_RUN = """
import importlib, pkgutil, sys
sys.modules['jax'] = None
sys.modules['repro'] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]
for name in names:
    importlib.import_module(name)
assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))
               for m, mod in sys.modules.items() if mod is not None)
from repro_torch.launch import serve
assert serve.main(['--device', 'cpu', '--requests', '2', '--max-batch', '2',
                   '--prompt-len', '4', '--max-new', '2']) == 0
import os, tempfile
from repro_torch.launch import train
with tempfile.TemporaryDirectory() as tmp:
    assert train.main(['--reduced', '--device', 'cpu', '--steps', '2',
                       '--ckpt-dir', os.path.join(tmp, 'ck')]) == 0
from repro_torch.workloads import campaign
with tempfile.TemporaryDirectory() as tmp:
    out = os.path.join(tmp, 'campaign.json')
    assert campaign.main(['--grid', 'mix_tiny', '--policy', 'paper', '--device', 'cpu',
                          '--out', out]) == 0
    assert os.path.exists(out)
    traces = os.path.join(tmp, 'traces')
    assert campaign.main(['--grid', 'mix_tiny', '--device', 'cpu', '--trace', traces,
                          '--out', os.path.join(tmp, 'mix_tiny.json')]) == 0
    from repro_torch import trace
    assert trace.main(['regress', 'goldens/mix_tiny_traces', traces]) == 0
    first = sorted(f for f in os.listdir(traces) if f.endswith('.trace.jsonl'))[0]
    assert trace.main(['replay', os.path.join(traces, first)]) == 0
from repro_torch.core import experiment
res = experiment.run_experiment(seed=0, sizes=(160,), horizon=2 * 86400.0)
assert res['DC'][160].completed > 0 and res['SC'].submitted == res['DC'][160].submitted
print('experiment completed', res['DC'][160].completed)
assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))
               for m, mod in sys.modules.items() if mod is not None)
print('imported', len(names))
"""


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_no_jax_and_no_repro():
    files = _port_sources()
    assert len(files) > 10
    scanned = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"training/optimizer.py", "training/train_step.py", "data/pipeline.py",
            "checkpoint/checkpointer.py", "runtime/elastic.py",
            "runtime/orchestrator.py", "configs/musicgen_large.py",
            "launch/train.py", "launch/mesh.py", "sharding/partitioning.py",
            "training/data_parallel.py"} <= scanned
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not offenders, offenders


def test_forbidden_pattern_catches_imports_but_not_the_port():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from jax import lax")
    assert FORBIDDEN.search("from repro.models import model")
    assert FORBIDDEN.search("import repro.configs")
    assert not FORBIDDEN.search("from repro_torch.models import model")
    assert not FORBIDDEN.search("import repro_torch.convert")


def test_port_imports_and_serves_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "served 2 requests" in proc.stdout
    assert "arch=deepseek-7b devices=1 start_step=0" in proc.stdout
    assert "step 2: loss=" in proc.stdout and "done; checkpoint at" in proc.stdout
    assert "campaign grid=mix_tiny cells=1" in proc.stdout
    assert "regress: pass — 7 cell(s) within thresholds" in proc.stdout
    assert "ok: replayed" in proc.stdout
    assert "experiment completed" in proc.stdout
    assert int(proc.stdout.split("imported")[-1]) >= 15


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve, train
    from repro_torch.runtime.device_pool import DevicePool
    from repro_torch.training.train_step import init_state
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        DevicePool()
    with pytest.raises(RuntimeError):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError):
        train.main(["--reduced", "--steps", "1"])
    from repro_torch.configs import get_config, reduced_config
    with pytest.raises(RuntimeError):
        init_state(reduced_config(get_config("recurrentgemma-2b")))
    assert resolve_device("cpu") == torch.device("cpu")
    assert DevicePool(devices=["cpu"]).devices == [torch.device("cpu")]
