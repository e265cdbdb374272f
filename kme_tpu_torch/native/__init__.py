"""Build and bind the port's native code: the host runtime and the CUDA
kernels.

The host runtime is `kme_router.cpp`, `kme_host.cpp`, `kme_wire.cpp` and
`kme_oracle.cpp` in this directory (copies of the JAX package's, byte for
byte): the seq router, the lanes scheduler, the batch plan and pack, the
wire parser and binary frames, the MatchOut reconstructor, and the
quirk-exact host engine behind `--engine native` (`native/oracle.py`).
`load_library` compiles them at first use with `g++` into one shared
object under `kme_tpu_torch/_build/`, named by the sources' content
hash, and binds every entry with ctypes. A failed
build or load raises; `KME_NATIVE=0` is the one way to run without it
(`load_library` then returns None and callers take their Python paths),
and `KME_NATIVE_SO` names a prebuilt library to load instead.

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
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
# ptxas report (registers, shared memory, spills) of each build
build_logs: dict = {}


# ---------------------------------------------------------------------------
# the host runtime (g++)

HOST_SRCS = tuple(os.path.join(_HERE, f) for f in
                  ("kme_host.cpp", "kme_oracle.cpp", "kme_wire.cpp",
                   "kme_router.cpp", "kme_front.cpp"))
HOST_CXX = "g++"
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_host_lib = None


class BoundaryError(ValueError):
    """A buffer about to cross the ctypes boundary is the wrong shape,
    dtype, length, or layout. The C side reads exactly the lengths it
    is told (kme_wire.cpp reads m_* to nmsg and r_*/h_* to nr with no
    way to check), so a short or mis-typed buffer is a native-side
    overread — this is raised Python-side instead."""


def check_buffer(name, arr, dtype, n=None):
    """Validate one array for a native call: exact dtype, C-contiguous,
    1-D, and (when given) at least `n` elements. Returns the array so
    call sites can validate inline."""
    import numpy as np

    if not isinstance(arr, np.ndarray):
        raise BoundaryError(
            f"{name}: expected ndarray, got {type(arr).__name__}")
    if arr.dtype != np.dtype(dtype):
        raise BoundaryError(
            f"{name}: dtype {arr.dtype} != required {np.dtype(dtype)}")
    if arr.ndim != 1:
        raise BoundaryError(f"{name}: expected 1-D, got shape "
                            f"{arr.shape}")
    if not arr.flags["C_CONTIGUOUS"]:
        raise BoundaryError(f"{name}: buffer is not C-contiguous")
    if n is not None and arr.shape[0] < n:
        raise BoundaryError(
            f"{name}: {arr.shape[0]} element(s), native call reads "
            f"{n} — short buffer would be an overread")
    return arr


def host_tag() -> str:
    """The first 16 hex digits of the host sources' sha256."""
    h = hashlib.sha256()
    for src in HOST_SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build_host(out: str) -> None:
    os.makedirs(BUILD, exist_ok=True)
    # build into a temporary name, then rename: processes that build at
    # once race harmlessly (os.replace is atomic)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        r = subprocess.run([HOST_CXX, *HOST_FLAGS, *HOST_SRCS, "-o", tmp],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(
                f"building the host runtime failed ({HOST_CXX} rc="
                f"{r.returncode}):\n{r.stderr[:2000]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library():
    """The host runtime library, built if needed; None only under
    KME_NATIVE=0. A failed build or dlopen raises."""
    global _host_lib
    if os.environ.get("KME_NATIVE", "1") == "0":
        return None
    with _lock:
        if _host_lib is None:
            path = os.environ.get("KME_NATIVE_SO")
            if not path:
                path = os.path.join(BUILD, f"kme_host_{host_tag()}.so")
                if not os.path.exists(path):
                    _build_host(path)
            try:
                _host_lib = _bind(ctypes.CDLL(path))
            except OSError as e:
                raise OSError(f"the host runtime {path} could not be "
                              f"loaded: {e}") from e
        return _host_lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    P64, P32 = c.POINTER(c.c_int64), c.POINTER(c.c_int32)
    sigs = {
        "kme_sched_new": ([c.c_int32, c.c_int32, c.c_int32], c.c_void_p),
        "kme_sched_free": ([c.c_void_p], None),
        "kme_sched_plan": ([c.c_void_p, c.c_int64] + [P64] * 6, c.c_int32),
        "kme_sched_n_placed": ([c.c_void_p], c.c_int64),
        "kme_sched_p_msg": ([c.c_void_p], P64),
        "kme_sched_p_seg": ([c.c_void_p], P32),
        "kme_sched_p_step": ([c.c_void_p], P32),
        "kme_sched_p_lane": ([c.c_void_p], P32),
        "kme_sched_p_act": ([c.c_void_p], P32),
        "kme_sched_p_aidx": ([c.c_void_p], P32),
        "kme_sched_p_oid": ([c.c_void_p], P64),
        "kme_sched_p_price": ([c.c_void_p], P32),
        "kme_sched_p_size": ([c.c_void_p], P32),
        "kme_sched_p_slot": ([c.c_void_p], P32),
        "kme_sched_n_barriers": ([c.c_void_p], c.c_int64),
        "kme_sched_b_msg": ([c.c_void_p], P64),
        "kme_sched_b_lane": ([c.c_void_p], P32),
        "kme_sched_b_mode": ([c.c_void_p], P32),
        "kme_sched_b_credit": ([c.c_void_p], P64),
        "kme_sched_n_rejects": ([c.c_void_p], c.c_int64),
        "kme_sched_r_msg": ([c.c_void_p], P64),
        "kme_sched_n_segments": ([c.c_void_p], c.c_int64),
        "kme_sched_seg_steps": ([c.c_void_p], P32),
        "kme_sched_n_program": ([c.c_void_p], c.c_int64),
        "kme_sched_program": ([c.c_void_p], P32),
        "kme_sched_err_value": ([c.c_void_p], c.c_int64),
        "kme_sched_n_accounts": ([c.c_void_p], c.c_int64),
        "kme_sched_n_symbols": ([c.c_void_p], c.c_int64),
        "kme_sched_n_routes": ([c.c_void_p], c.c_int64),
        "kme_sched_rr_lane": ([c.c_void_p], c.c_int32),
        "kme_sched_set_rr_lane": ([c.c_void_p, c.c_int32], None),
        "kme_sched_export_accounts": ([c.c_void_p, P64, P32], None),
        "kme_sched_export_symbols": ([c.c_void_p, P64, P32], None),
        "kme_sched_export_routes": ([c.c_void_p, P64, P64], None),
        "kme_sched_import_accounts": ([c.c_void_p, c.c_int64, P64, P32], None),
        "kme_sched_import_symbols": ([c.c_void_p, c.c_int64, P64, P32], None),
        "kme_sched_import_routes": ([c.c_void_p, c.c_int64, P64, P64], None),
        # native quirk-exact engine (kme_oracle.cpp)
        "kme_oracle_new": ([c.c_int32, c.c_int32, c.c_int64, c.c_int32,
                            c.c_int64], c.c_void_p),
        "kme_oracle_free": ([c.c_void_p], None),
        "kme_oracle_process": ([c.c_void_p, c.c_int64] + [P64] * 6
                               + [P64, c.POINTER(c.c_uint8),
                                  P64, c.POINTER(c.c_uint8)], c.c_int32),
        "kme_oracle_err_index": ([c.c_void_p], c.c_int64),
        "kme_oracle_err_msg": ([c.c_void_p], c.c_char_p),
        "kme_oracle_out_buf": ([c.c_void_p], c.c_void_p),
        "kme_oracle_out_len": ([c.c_void_p], c.c_int64),
        "kme_oracle_line_counts": ([c.c_void_p], P64),
        "kme_oracle_n_processed": ([c.c_void_p], c.c_int64),
        "kme_oracle_dump_state": ([c.c_void_p], c.c_char_p),
        "kme_oracle_load_state": ([c.c_void_p, c.c_char_p], c.c_int32),
        # native seq router (kme_router.cpp)
        "kme_router_new": ([c.c_int64, c.c_int64], c.c_void_p),
        "kme_router_free": ([c.c_void_p], None),
        "kme_router_route": ([c.c_void_p, c.c_int64] + [P64] * 6,
                             c.c_int32),
        "kme_router_n_routed": ([c.c_void_p], c.c_int64),
        "kme_router_n_rejects": ([c.c_void_p], c.c_int64),
        "kme_router_err_value": ([c.c_void_p], c.c_int64),
        "kme_router_o_msg": ([c.c_void_p], P64),
        "kme_router_o_oid": ([c.c_void_p], P64),
        "kme_router_o_act": ([c.c_void_p], P32),
        "kme_router_o_aidx": ([c.c_void_p], P32),
        "kme_router_o_price": ([c.c_void_p], P32),
        "kme_router_o_size": ([c.c_void_p], P32),
        "kme_router_o_lane": ([c.c_void_p], P32),
        "kme_router_o_rej": ([c.c_void_p], P64),
        "kme_router_n_accounts": ([c.c_void_p], c.c_int64),
        "kme_router_n_symbols": ([c.c_void_p], c.c_int64),
        "kme_router_n_routes": ([c.c_void_p], c.c_int64),
        "kme_router_export_accounts": ([c.c_void_p, P64, P32], None),
        "kme_router_export_symbols": ([c.c_void_p, P64, P32], None),
        "kme_router_export_routes": ([c.c_void_p, P64, P64], None),
        "kme_router_import_accounts": ([c.c_void_p, c.c_int64, P64, P32],
                                       None),
        "kme_router_import_symbols": ([c.c_void_p, c.c_int64, P64, P32],
                                      None),
        "kme_router_import_routes": ([c.c_void_p, c.c_int64, P64, P64],
                                     None),
        # consistent-hash group assignment (kme_router.cpp, stateless)
        "kme_group_assign": ([c.c_int64, P64, c.c_int32, c.c_int64,
                              P32], None),
        # native wire reconstruction (kme_wire.cpp)
        "kme_recon_new": ([], c.c_void_p),
        "kme_recon_free": ([c.c_void_p], None),
        "kme_recon_buf": ([c.c_void_p], c.c_void_p),
        "kme_recon_len": ([c.c_void_p], c.c_int64),
        "kme_recon_n_lines": ([c.c_void_p], c.c_int64),
        "kme_recon_line_off": ([c.c_void_p], P64),
        "kme_recon_msg_lines": ([c.c_void_p], P32),
        "kme_recon_wire": ([c.c_int64] + [P64] * 6
                           + [P64, c.POINTER(c.c_uint8)] * 2
                           + [c.POINTER(c.c_uint8), P32,
                              c.POINTER(c.c_uint8), P32, P64, P64, P64,
                              c.POINTER(c.c_uint8), P64]
                           + [c.c_int64] + [P64] * 4 + [c.c_void_p],
                           c.c_int32),
        # native batch plan + H2D pack (kme_host.cpp kme_pack_*)
        "kme_pack_new": ([], c.c_void_p),
        "kme_pack_free": ([c.c_void_p], None),
        "kme_plan_batch": ([c.c_void_p, c.c_void_p, c.c_int64]
                           + [P64] * 6 + [c.c_int32], c.c_int64),
        "kme_pack_planes": ([c.c_void_p], P32),
        "kme_pack_err_index": ([c.c_void_p], c.c_int64),
        # per-shard async-dispatch window slicing (kme_host.cpp)
        "kme_shard_slice": ([P32] + [c.c_int64] * 4 + [P64]
                            + [c.c_int64] * 2 + [P32], None),
        # native one-pass batch reconstruction (kme_wire.cpp)
        "kme_recon_batch": ([c.c_int64] + [P64] * 6
                            + [P64, c.POINTER(c.c_uint8)] * 2
                            + [c.c_int64, P64, P32, P32]
                            + [c.POINTER(c.c_uint8), P64, P64, P64,
                               c.POINTER(c.c_uint8)]
                            + [c.c_int64, P64, c.c_int64, P64]
                            + [c.c_int64] + [P64] * 4 + [c.c_void_p],
                            c.c_int32),
        # native wire parsing (kme_wire.cpp kme_parse_*)
        "kme_parse_new": ([], c.c_void_p),
        "kme_parse_free": ([c.c_void_p], None),
        "kme_parse_lines": ([c.c_void_p, c.c_char_p, c.c_int64],
                            c.c_int64),
        "kme_parse_col": ([c.c_void_p, c.c_int32], P64),
        "kme_parse_hnext": ([c.c_void_p], c.POINTER(c.c_uint8)),
        "kme_parse_hprev": ([c.c_void_p], c.POINTER(c.c_uint8)),
        "kme_parse_tid": ([c.c_void_p], P64),
        "kme_parse_htid": ([c.c_void_p], c.POINTER(c.c_uint8)),
        # binary order frames + canonical-JSON emission (kme_wire.cpp)
        "kme_parse_frames": ([c.c_void_p, c.c_char_p, c.c_int64],
                             c.c_int64),
        "kme_parse_err_off": ([c.c_void_p], c.c_int64),
        "kme_parse_emit": ([c.c_void_p], c.c_int64),
        "kme_parse_emit_buf": ([c.c_void_p], c.c_void_p),
        "kme_parse_emit_off": ([c.c_void_p], P64),
        # native front-door acceptor (kme_front.cpp): validate + route
        # + plan in one call per batch
        "kme_front_new": ([], c.c_void_p),
        "kme_front_free": ([c.c_void_p], None),
        "kme_front_accept": ([c.c_void_p, c.c_char_p, c.c_int64,
                              c.c_int32, c.c_int64, c.c_int64,
                              c.c_void_p, c.c_void_p, c.c_int32],
                             c.c_int64),
        "kme_front_groups": ([c.c_void_p], P32),
        "kme_front_plan_k": ([c.c_void_p], c.c_int64),
        "kme_front_err_off": ([c.c_void_p], c.c_int64),
        "kme_front_col": ([c.c_void_p, c.c_int32], P64),
        "kme_front_hnext": ([c.c_void_p], c.POINTER(c.c_uint8)),
        "kme_front_hprev": ([c.c_void_p], c.POINTER(c.c_uint8)),
        "kme_front_tid": ([c.c_void_p], P64),
        "kme_front_htid": ([c.c_void_p], c.POINTER(c.c_uint8)),
        "kme_front_json": ([c.c_void_p], c.c_int64),
        "kme_front_json_buf": ([c.c_void_p], c.c_void_p),
        "kme_front_json_off": ([c.c_void_p], P64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


# ---------------------------------------------------------------------------
# the CUDA kernels (nvcc)


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
