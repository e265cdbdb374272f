"""Build and bind the port's CUDA kernels.

Each kernel source in `kme_tpu_torch/csrc/` is compiled at first use by
`nvcc` for Hopper (`sm_90a`) into a shared library with a plain C
interface under `kme_tpu_torch/_build/`, named by the source's content
hash, and loaded with ctypes. Nothing here runs at import time; a
missing `nvcc`, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import functools
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


def _lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}_{source_sha256(name)[:16]}.so")


def build_many(names, fresh: bool = False) -> dict:
    """Compile each csrc/<name>.cu whose content-named library is missing
    (or every one with `fresh`), one nvcc per source, all started
    together; -> {name: library path}."""
    os.makedirs(BUILD, exist_ok=True)
    libs = {n: _lib_path(n) for n in names}
    procs = {}
    for n, lib in libs.items():
        if os.path.exists(lib) and not fresh:
            build_logs.setdefault(n, "(cached build)")
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[n] = (tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC, f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (rc={p.returncode}):\n"
                          f"{out}\n{err}")
            continue
        os.replace(tmp, libs[n])
        build_logs[n] = (out + err).strip()
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str, fresh: bool = False) -> str:
    """Compile csrc/<name>.cu (if its content-named library is missing,
    or always with `fresh`) and return the library path."""
    return build_many([name], fresh)[name]


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
    message columns, the state planes, the output plane and the
    rows-in-use scratch (all CUDA, checked by the caller): 7 + 18 + 2 in
    fixed mode, 12 + 25 + 2 in java mode; `dims`: (K, S, NR, A, E, B,
    CAPR, FB, PROBE, STAGE)."""
    import torch

    fn = _seq_fn(java)
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    d = (ctypes.c_int * len(dims))(*dims)
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = fn(ptrs, len(tensors), d, len(dims), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"seq_step launch failed: CUDA error {rc}")


def launch_rows_in_use(bs, occ, nr: int) -> None:
    """Launch seq_step.cu's rows-in-use kernel on the current stream:
    `bs` (sides * nr, 128) -> `occ`, one int32 per side (both CUDA int32,
    contiguous, checked by the caller)."""
    import torch

    fn = load("seq_step").kme_rows_in_use
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(bs.device).cuda_stream
    rc = fn(bs.data_ptr(), occ.data_ptr(), occ.numel(), nr, stream)
    if rc != 0:
        raise RuntimeError(f"rows_in_use launch failed: CUDA error {rc}")


# argument types of the row-copy entries (p: a pointer or the stream,
# i: an int), after csrc/rowdma.cu
_ROWDMA_ARGS = {
    "kme_gather_lane_rows": "pppiiiip",
    "kme_scatter_lane_rows": "pppiiiiip",
    "kme_gather_pos_rows": "pppppiiiip",
    "kme_scatter_pos_rows": "pppppiiiiip",
}
_rowdma_fns: dict = {}


def _rowdma_fn(entry: str):
    fn = _rowdma_fns.get(entry)
    if fn is None:
        fn = getattr(load("rowdma"), entry)
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in _ROWDMA_ARGS[entry]]
        fn.restype = ctypes.c_int
        _rowdma_fns[entry] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_rowdma(entry: str, tensors, ints, planes) -> None:
    """One row-copy entry on the current stream: `tensors` (all CUDA,
    contiguous, shapes checked by the caller) as pointers, then S, W, the
    plane's row words, `ints`, the SM count and the stream."""
    import torch

    flat, lanes = planes[0], tensors[len(planes)]
    for t in tensors:
        if t is not lanes and t.data_ptr() % 16:
            raise ValueError("row copies need 16-byte aligned tensors")
    dev = flat.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _rowdma_fn(entry)(
        *[t.data_ptr() for t in tensors], flat.shape[0], lanes.shape[0],
        flat[0].numel(), *ints, _sms(dev.index), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def launch_rowdma_gather(flat, lanes, out) -> None:
    """B4, (1, planar), on the current stream: out[w] = flat[lanes[w]]
    (all CUDA int32)."""
    _launch_rowdma("kme_gather_lane_rows", (flat, lanes, out), (), (flat,))


def launch_rowdma_scatter(flat, lanes, rows, skip_lane: int) -> None:
    """B5, (1, planar), on the current stream: flat[lanes[w]] = rows[w] in
    place, skipping `skip_lane` (all CUDA int32)."""
    _launch_rowdma("kme_scatter_lane_rows", (flat, lanes, rows),
                   (int(skip_lane),), (flat,))


def launch_pos_gather(pa, pv, lanes, pa_blk, pv_blk) -> None:
    """B4, (2, joined), on the current stream: both planes' rows `lanes`
    joined into the (W, A) int64 blocks."""
    _launch_rowdma("kme_gather_pos_rows", (pa, pv, lanes, pa_blk, pv_blk),
                   (), (pa, pv))


def launch_pos_scatter(pa, pv, lanes, pa_blk, pv_blk, skip_lane: int) -> None:
    """B5, (2, joined), on the current stream: the (W, A) int64 blocks
    split back into both planes' rows `lanes` in place, skipping
    `skip_lane`."""
    _launch_rowdma("kme_scatter_pos_rows", (pa, pv, lanes, pa_blk, pv_blk),
                   (int(skip_lane),), (pa, pv))
