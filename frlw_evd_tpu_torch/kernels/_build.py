"""Build the port's CUDA kernels with nvcc, load and call them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (pointers and the CUDA
stream as `void*`, sizes as `int`; every function returns
`cudaGetLastError()`), so it compiles in seconds without PyTorch's
headers. The shared library goes to `build/kernels/lib<name>.so` beside
the package and is rebuilt when its source is newer.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc, and a kernel is built on its first launch (or all at
once, in parallel, by `build()`).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("scatter_hist", "scatter_sorted", "scatter_dense", "taf_update",
           "bfm_chain", "int8_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def so_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _inputs(name: str) -> set[Path]:
    """csrc/<name>.cu and every csrc header it includes, transitively."""
    seen: set[Path] = set()
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_text()):
            header = path.parent / inc
            if header.exists():
                todo.append(header)
    return seen


def _stale(name: str) -> bool:
    so = so_path(name)
    if not so.exists():
        return True
    built = so.stat().st_mtime
    return any(built < src.stat().st_mtime for src in _inputs(name))


def build(names=SOURCES) -> dict[str, str]:
    """Compile every stale source in parallel (one nvcc per file, all
    started together). Returns each built kernel's compiler log (ptxas
    register and spill report); raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    logs, errors = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode:
            errors.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, so_path(name))
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(so_path(name)))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def launch(name: str, entry: str, tensors, ints, device) -> None:
    """Call the C entry `entry` of csrc/<name>.cu with the tensors' data
    pointers (null for None), then the ints, then `device`'s current CUDA
    stream; raise if it returns a CUDA error."""
    fn = getattr(load(name), entry)
    fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                   + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    check(fn(*(None if t is None else t.data_ptr() for t in tensors), *ints,
             stream), entry)
