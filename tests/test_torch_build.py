"""The port's kernel build (``repro_torch.kernels._build``), on the CPU: the
shared Hopper header is one file that the tensor-core kernels include, and
an edit to it changes the build directory, so every kernel is rebuilt."""
import subprocess
from pathlib import Path

import pytest

pytest.importorskip("torch")
from repro_torch.kernels import _build  # noqa: E402

KERNELS = Path(_build.__file__).parent


def test_shared_header_is_hashed_and_included():
    assert "common/hopper.cuh" in _build.headers()
    for name in ("flash_attention", "mlstm_chunk"):
        source = _build.sources()[name].read_text()
        assert '#include "common/hopper.cuh"' in source
        for helper in ("void mbar_init", "void tma_load_4d", "uint64_t smem_desc",
                       "void wgmma_rs_n256", "cudaError_t encode_map"):
            assert helper not in source, (name, helper)       # one home, no copies
    header = (KERNELS / "common" / "hopper.cuh").read_text()
    for helper in ("void mbar_init", "void tma_load_4d", "uint64_t smem_desc",
                   "void wgmma_rs_n256", "void wgmma_ss_n256", "cudaError_t encode_map"):
        assert helper in header


def test_nvcc_command_includes_the_kernels_directory():
    cmd = _build.command("nvcc", "mlstm_chunk", Path("out.so"))
    assert cmd[cmd.index("-I") + 1] == str(KERNELS)
    assert cmd[-1] == str(_build.sources()["mlstm_chunk"])
    assert "arch=compute_90a,code=sm_90a" in cmd


def test_an_edited_header_changes_the_build_directory(tmp_path, monkeypatch):
    header = tmp_path / "extra.cuh"
    header.write_text("// one\n")
    real = _build.headers()
    monkeypatch.setattr(_build, "headers", lambda: {**real, "extra.cuh": header})
    before = _build.build_dir()
    assert _build.build_dir() == before                   # stable for the same bytes
    header.write_text("// two\n")
    assert _build.build_dir() != before


def test_a_variant_builds_beside_the_served_libraries(tmp_path, monkeypatch):
    """``load_variant`` runs the served build's nvcc command with the one
    extra flag, into its own directory of the same build, and keeps the log."""
    calls = []

    def run(cmd, **_):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info : Used 40 registers\n", "")

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build, "_open", lambda path: path)
    flag = "-DREPRO_SLSTM_PHASES"
    path = _build.load_variant.__wrapped__("slstm_scan", flag)
    assert path == _build.variant_dir(flag) / "libslstm_scan.so" and path.exists()
    assert _build.variant_dir(flag).parent.parent == _build.build_dir()
    served = _build.command("nvcc", "slstm_scan", Path("out.so"))
    assert calls[0][0] == "nvcc" and calls[0][1] == flag
    assert calls[0][2:calls[0].index("-o")] == served[1:served.index("-o")]
    assert "Used 40 registers" in _build.variant_log("slstm_scan", flag)
    _build.load_variant.__wrapped__("slstm_scan", flag)
    assert len(calls) == 1                               # built once per source hash


def test_ptxas_registers_reads_each_entry_function():
    log = """ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'
ptxas info    : Function properties for _Z1av
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers
"""
    assert _build.ptxas_registers(log) == [["_Z1av", 255, 4], ["_Z1bv", 64, 0]]
