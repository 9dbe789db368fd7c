"""The port's kernel build (``repro_torch.kernels._build``), on the CPU: the
shared Hopper header is one file that the tensor-core kernels include, and
an edit to it changes the build directory, so every kernel is rebuilt."""
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
