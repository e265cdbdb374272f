"""Build and bind the port's CUDA kernels.

Each kernel source in `kme_tpu_torch/csrc/` is compiled at first use by
`nvcc` for Hopper (`sm_90a`) into a shared library with a plain C
interface under `kme_tpu_torch/_build/`, named by the source's content
hash, and loaded with ctypes. Nothing here runs at import time; a
missing `nvcc`, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
# ptxas report (registers, shared memory, spills) of each build
build_logs: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def source_sha256(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def build(name: str, fresh: bool = False) -> str:
    """Compile csrc/<name>.cu (if its content-named library is missing,
    or always with `fresh`) and return the library path."""
    src = os.path.join(CSRC, f"{name}.cu")
    os.makedirs(BUILD, exist_ok=True)
    lib = os.path.join(BUILD, f"lib{name}_{source_sha256(name)[:16]}.so")
    if os.path.exists(lib) and not fresh:
        build_logs.setdefault(name, "(cached build)")
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={r.returncode}):\n"
                           f"{r.stdout}\n{r.stderr}")
    os.replace(tmp, lib)
    build_logs[name] = (r.stdout + r.stderr).strip()
    return lib


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib


def _seq_fn(java: bool):
    lib = load("seq_step")
    fn = lib.kme_seq_scan_java if java else lib.kme_seq_scan
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_seq_scan(tensors, dims, java: bool = False) -> None:
    """Launch the seq_step kernel on the current stream. `tensors`: the
    message columns, the state planes and the output plane (all CUDA,
    checked by the caller): 7 + 18 + 1 in fixed mode, 12 + 25 + 1 in
    java mode; `dims`: (K, S, NR, A, E, B, CAPR, FB, PROBE)."""
    import torch

    fn = _seq_fn(java)
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    d = (ctypes.c_int * len(dims))(*dims)
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = fn(ptrs, len(tensors), d, len(dims), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"seq_step launch failed: CUDA error {rc}")
