"""The benchmark finds a cell, a mix, a metric and a kernel by name, and a new
one of each is new files alone; BENCHMARK.json keeps to the contract's
shape."""
import json
import re
import shutil

import pytest

from portbench.core import registry, trace
from portbench.core.run import Call

import portbench_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def test_finds_each_part_by_name(bench):
    cell = registry.cell(bench, "xlstm-train-2k")
    assert cell.spec["driver"] == "train"
    assert cell.traffic["kind"] == "tokens" and cell.traffic["seq_len"] == 2048
    assert cell.model["num_layers"] == 48 and cell.reference.__name__.endswith("xlstm")
    assert callable(registry.metric("train.mfu.xlstm").read)
    kernels = registry.kernels()
    assert {"mlstm_fwd", "mlstm_bwd", "slstm_fwd", "slstm_bwd", "flash_fwd",
            "flash_bwd"} <= set(kernels)
    with pytest.raises(KeyError):
        registry.cell(bench, "no-such-cell")


def test_benchmark_json_keeps_the_contract(bench):
    root = registry.ROOT
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (root / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        registry.cell(bench, w["name"])              # its cell and traffic files exist
    names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", ())) <= cells
        assert (registry.PKG / "metrics" / f"{m['name']}.py").is_file()
    assert {m["name"]: m for m in bench["end_to_end"]}["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = [m["name"] for m in bench["end_to_end"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for cell in cells:
        reported = [m["name"] for m in registry.metrics_of(bench, cell, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert registry.metrics_of(bench, cell, True)


def test_a_new_cell_mix_metric_and_kernel_are_new_files_alone(bench, tmp_path):
    """Copy the benchmark, add one file of each kind and an entry in
    BENCHMARK.json, and run the new cell: the runner is not touched."""
    pkg = tmp_path / "portbench"
    shutil.copytree(registry.PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (pkg / "traffic" / "train-2x32.json").write_text(json.dumps(
        {"kind": "tokens", "batch": 2, "seq_len": 32, "zipf": 1.1, "distinct_batches": 3}))
    spec = json.loads((pkg / "cells" / "xlstm-train-2k.json").read_text())
    (pkg / "cells" / "xlstm-train-tiny.json").write_text(json.dumps(spec))
    (pkg / "kernels" / "everything.py").write_text(
        "DEVICE_NAMES = ('',)\nPRECISION = 'fp32'\n\n\n"
        "def calls(model, call):\n    return [(1.0e9, 0)] if call.phase == 'train' else []\n")
    (pkg / "metrics" / "train.steps_in_window.py").write_text(
        "def read(run):\n    return float(run.window['steps'])\n")
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [{
        "name": "xlstm-train-tiny", "config": "xlstm-1.3b", "traffic": "train-2x32",
        "chips": 1, "why": "a test's cell"}]
    new["per_layer"] = bench["per_layer"] + [{
        "name": "train.steps_in_window", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "trainer", "moves": "train_tokens_per_s.xlstm",
        "workloads": ["xlstm-train-tiny"]}]
    cell = registry.cell(new, "xlstm-train-tiny", root=registry.ROOT, pkg=pkg)
    assert cell.traffic["seq_len"] == 32
    assert "everything" in registry.kernels(pkg)
    run = portbench_tiny.run_tiny(new, cell, seconds=0.1, keep_traffic=True)
    assert run.window["seq_len"] == 32 and run.window["steps"] >= 1
    assert registry.load_file(pkg / "metrics" / "train.steps_in_window.py").read(run) >= 1
    entries = [m["name"] for m in registry.metrics_of(new, "xlstm-train-tiny", True)]
    assert "train.steps_in_window" in entries and "train.mfu.xlstm" not in entries


def test_kernel_share_reads_its_own_names():
    """A kernel file's share is its calls' bound over the device time of
    the kernels it names; none of its kernels in the trace reads None."""
    from portbench.core import readers

    class FakeTrace:
        def kernel_s(self, names):
            return 2e-3 if "slstm_scan_kernel" in names else 0.0

    class FakeRun:
        model = registry.cell(registry.benchmark(), "xlstm-train-2k").model
        calls = [Call("prefill", 4, 512)]
        trace = FakeTrace()
    share = readers.kernel_share(FakeRun, ["slstm_fwd"])
    from portbench.core import peaks, work
    bound = 6 * peaks.bound_s(*work.slstm(4, 512, 4, 512), "fp32")
    assert share == pytest.approx(100 * bound / 2e-3)
    assert readers.kernel_share(FakeRun, ["flash_fwd"]) is None
    assert trace.SPAN == "portbench."


def test_a_kernel_file_added_later_moves_no_kernels_roofline(monkeypatch):
    """Each cell's ``kernels_roofline`` sums the kernel files its reader
    names; a new kernel file with work in the same steps leaves it as it was."""
    from types import ModuleType

    class FakeTrace:
        def kernel_s(self, names):
            return 1e-3 * len(names)

    bench = registry.benchmark()
    for cell, kernels in (("xlstm-train-2k", {"mlstm_fwd", "mlstm_bwd", "slstm_fwd", "slstm_bwd"}),
                          ("musicgen-train-30s", {"flash_fwd", "flash_bwd"})):
        reader = registry.metric(f"train.kernels_roofline.{cell.split('-')[0]}")
        assert set(reader.KERNELS) == kernels and kernels <= set(registry.kernels())

        class FakeRun:
            model = registry.cell(bench, cell).model
            calls = [Call("train", 2, 512, remat=True)]
            trace = FakeTrace()
        before = reader.read(FakeRun)
        extra = ModuleType("everything")
        extra.DEVICE_NAMES, extra.PRECISION = ("",), "fp32"
        extra.calls = lambda model, call: [(1.0e12, 0)]
        files = dict(registry.kernels(), everything=extra)
        monkeypatch.setattr(registry, "kernels", lambda pkg=registry.PKG: files)
        assert before is not None and reader.read(FakeRun) == before
        monkeypatch.undo()
