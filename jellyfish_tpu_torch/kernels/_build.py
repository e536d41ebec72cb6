"""Build the CUDA sources under csrc/ with nvcc at first use, load with ctypes.

Each csrc/<name>.cu has a plain C interface and compiles on its own into
build/jellyfish_tpu_torch/lib<name>.so at the repository root (no PyTorch
headers, so a build takes seconds); csrc/*.cuh are headers the sources
share. A library is rebuilt when its source or a header is newer. `build`
starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "build", "load", "check"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jellyfish_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Whether lib<name>.so is missing or older than its source or any
    header under csrc/."""
    src, out = _paths(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return out.stat().st_mtime < newest


def build(names) -> None:
    """Compile the stale libraries among `names`, one nvcc each, all at
    once. The ptxas report of each build is kept in
    BUILD_DIR/lib<name>.log."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        src, out = _paths(n)
        tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ), tmp, out)
    errors = []
    for n, (p, tmp, out) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        (BUILD_DIR / f"lib{n}.log").write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed. Its
    entry points are typed once, at first load, from `signatures`:
    {function name: (restype, [argtypes])}."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_paths(name)[1]))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
