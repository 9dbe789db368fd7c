"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Every ``<kernel>/csrc/*.cu`` of this package is compiled for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. Sources
include shared headers (``*.cuh``, e.g. ``common/hopper.cuh``) relative to
this directory. The output directory ``build/repro_torch_kernels/<hash>/``
(under the repository root, ignored by git) is keyed by a hash of the
sources, the headers and the flags, so an edited source or header is rebuilt
and an unchanged one is reused. All sources compile in
parallel, one ``nvcc`` each. A failed build raises with nvcc's stderr.
``load_variant`` builds one kernel again with an extra flag (a diagnostic
``-D``, e.g. the phase clocks of the ``phases`` tools) into
``variants/<flag>/`` of the same directory.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

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


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load kernel library ``name`` (once per process)."""
    return _open(build_all()[name])


def variant_dir(flag: str) -> Path:
    """Where ``load_variant`` builds the libraries compiled with ``flag``."""
    return build_dir() / "variants" / flag.removeprefix("-D")


@functools.cache
def load_variant(name: str, flag: str) -> ctypes.CDLL:
    """Build (once per source hash) and load kernel library ``name``
    compiled with the extra nvcc ``flag``, into ``variant_dir(flag)``
    beside the served libraries; nvcc's output goes to ``<name>.log``
    there (``variant_log``). The caller binds the variant's own entry
    points."""
    out_dir = variant_dir(flag)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"lib{name}.so"
    if not path.exists():
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = command(_nvcc(), name, tmp)
        proc = subprocess.run([cmd[0], flag, *cmd[1:]], capture_output=True, text=True)
        (out_dir / f"{name}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name} with {flag} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    return _open(path)


def variant_log(name: str, flag: str) -> str:
    """nvcc/ptxas output of ``load_variant(name, flag)``'s build."""
    return (variant_dir(flag) / f"{name}.log").read_text()


def ptxas_registers(log: str) -> List[list]:
    """[kernel, registers, spill stores] of each entry function in a
    ptxas ``-v`` log (ptxas prints a kernel's spills before its registers)."""
    out, kernel, spills = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel, spills = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append([kernel, int(m.group(1)), spills])
            kernel = None
    return out


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {err} ({msg})")


def int64_array(values) -> ctypes.Array:
    return (ctypes.c_int64 * len(values))(*values)
