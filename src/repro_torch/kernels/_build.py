"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Every ``<kernel>/csrc/*.cu`` of this package is compiled for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. Sources
include shared headers (``*.cuh``, e.g. ``common/hopper.cuh``) relative to
this directory. The output directory ``build/repro_torch_kernels/<hash>/``
(under the repository root, ignored by git) is keyed by a hash of the
sources, the headers and the flags, so an edited source or header is rebuilt
and an unchanged one is reused. All sources compile in
parallel, one ``nvcc`` each. A failed build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
REPO_ROOT = _PKG.parents[2]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> Dict[str, Path]:
    """Kernel name (the ``.cu`` stem) -> source path."""
    return {p.stem: p for p in sorted(_PKG.glob("*/csrc/*.cu"))}


def headers() -> Dict[str, Path]:
    """Every shared header (``*.cuh``) under this package, by relative path."""
    return {str(p.relative_to(_PKG)): p for p in sorted(_PKG.rglob("*.cuh"))}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def command(nvcc: str, name: str, out: Path) -> list:
    """The nvcc command that builds kernel ``name`` into ``out``; headers are
    included relative to this package."""
    return [nvcc, *NVCC_FLAGS, "-I", str(_PKG), "-o", str(out), str(sources()[name])]


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, path in (*sources().items(), *headers().items()):
        h.update(name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every kernel library that is missing; return name -> ``.so``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in sources()}
    todo = [n for n, p in libs.items() if not p.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            command(nvcc, name, tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        (out_dir / f"{name}.log").write_text(stdout + stderr)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                          f"{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def build_log() -> str:
    """nvcc/ptxas output of the current build (registers, shared memory)."""
    d = build_dir()
    return "".join((d / f"{n}.log").read_text() for n in sources()
                   if (d / f"{n}.log").exists())


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load kernel library ``name`` (once per process)."""
    lib = ctypes.CDLL(str(build_all()[name]))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {err} ({msg})")


def int64_array(values) -> ctypes.Array:
    return (ctypes.c_int64 * len(values))(*values)
