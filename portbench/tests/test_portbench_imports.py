"""Nothing the benchmark runs imports JAX or the JAX package ``repro`` (by
the whole top-level name: ``repro_torch`` is not ``repro``), and the
reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

from portbench.core import registry
from portbench.core.cli import FORBIDDEN


def top_levels(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = [p for p in registry.PKG.rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) > 30
    for p in files:
        assert not set(top_levels(p)) & set(FORBIDDEN), p


def test_the_reference_imports_nothing_of_the_program():
    for p in (registry.PKG / "reference").glob("*.py"):
        assert "repro_torch" not in set(top_levels(p)), p


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, torch, portbench_tiny\n"
        "from portbench.core import cli, registry\n"
        "b = registry.benchmark()\n"
        "run = portbench_tiny.run_tiny(b, registry.cell(b, 'xlstm-train-2k'), seconds=0.05)\n"
        "cli.result(run, False)\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    here = os.path.dirname(__file__)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(registry.ROOT), str(registry.ROOT / "src"), here]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout.splitlines()[-1]
    loaded = set(eval(out))
    assert "repro_torch" in loaded and not loaded & set(FORBIDDEN)
