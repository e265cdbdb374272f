"""Row copies by lane id: in-place per-lane row updates of big state.

The port of `kme_tpu/ops/rowdma.py`. The sweep engine's position state
is (lanes x accounts) — 67 MB at the `kme-serve` defaults as planar
int32 rows — but each scan step touches only the W active lanes' rows.
Two kernels move just those rows, each in two instantiations:

  gather_lane_rows:  copy the W rows `flat[lanes[w]]` into a (W, SUB, LN)
                     block (B4, `_gather_kernel`);
  scatter_lane_rows: copy updated rows back into `flat` in place,
                     skipping the scrap lane (B5, `_scatter_kernel`);
  gather_pos_rows / scatter_pos_rows: the same for both position planes
                     in one launch, with the (W, A) int64 blocks the lanes
                     step computes on joined / split inside the kernel —
                     what the step launches.

The kernels are `csrc/rowdma.cu`; the wrappers below take the plain
PyTorch versions (`*_reference`) only for tensors on the CPU, and launch
the kernel or raise for CUDA tensors.

The planar layout is the JAX package's: 64-bit state is stored as int32
[lo | hi] halves per row, shaped (SUB, LN) tiles, and joined to int64
only on the small (W, A) blocks (join_rows / split_rows, which the pos
kernels fuse). pack64_np and unpack64_np are the one definition of that
layout on the host.
"""

from __future__ import annotations

import numpy as np
import torch

LN = 128  # minor dim of every row tile

# launches of each kernel that ran (a caller that wants the count of one
# run resets it first): a wrapper adds one where it launches, except
# while the current stream is being captured into a CUDA graph — then it
# adds to CAPTURED, and the graph's owner adds that count to LAUNCHES at
# every replay (`replayed`)
LAUNCHES = {"gather": 0, "scatter": 0, "gather_pos": 0, "scatter_pos": 0}
CAPTURED = dict.fromkeys(LAUNCHES, 0)


def _launched(key: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[key] += 1
    else:
        LAUNCHES[key] += 1


def replayed(counts: dict, times: int = 1) -> None:
    """Count `times` replays of a graph that holds `counts` launches."""
    for k, n in counts.items():
        LAUNCHES[k] += n * times


def row_shape(width: int) -> tuple:
    """(SUB, LN) tile shape for a row of `width` int32 elements."""
    if width % LN != 0:
        raise ValueError(f"row width {width} must be a multiple of {LN}")
    return width // LN, LN


def join64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Reassemble int64 from planar int32 halves."""
    return (lo.to(torch.int64) & 0xFFFFFFFF) | (hi.to(torch.int64) << 32)


def split64(v: torch.Tensor) -> tuple:
    """int64 -> (lo, hi) int32 halves (a narrowing conversion keeps the
    low 32 bits)."""
    return v.to(torch.int32), (v >> 32).to(torch.int32)


def pack64_np(flat64: np.ndarray, lanes: int) -> np.ndarray:
    """Host-side: (lanes, A) or (lanes*A,) s64 -> (lanes, SUB, LN) planar
    i32 [lo | hi] rows."""
    v = np.asarray(flat64, np.int64).reshape(lanes, -1)
    lo = (v & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)
    hi = (v >> 32).astype(np.int32)
    return np.concatenate([lo, hi], axis=1).reshape(
        (lanes,) + row_shape(2 * v.shape[1]))


def unpack64_np(rows: np.ndarray, lanes: int) -> np.ndarray:
    """Inverse of pack64_np: planar i32 rows -> (lanes, A) s64."""
    v = np.asarray(rows, np.int32).reshape(lanes, -1)
    A = v.shape[1] // 2
    return ((v[:, :A].astype(np.int64) & 0xFFFFFFFF)
            | (v[:, A:].astype(np.int64) << 32))


def join_rows(rows: torch.Tensor) -> torch.Tensor:
    """(W, SUB, LN) planar i32 rows -> (W, A) s64 block: one copy that
    pairs each lo with its hi, read as int64 (both host and card are
    little-endian)."""
    W = rows.shape[0]
    v = rows.reshape(W, 2, -1).transpose(1, 2).contiguous()    # (W, A, 2)
    return v.view(torch.int64).reshape(W, -1)


def split_rows(blk: torch.Tensor) -> torch.Tensor:
    """(W, A) s64 block -> (W, SUB, LN) planar i32 rows (one copy)."""
    W, A = blk.shape
    v = blk.contiguous().view(torch.int32).reshape(W, A, 2)
    return v.transpose(1, 2).contiguous().reshape((W,) + row_shape(2 * A))


# ---------------------------------------------------------------------------
# plain PyTorch versions

def gather_lane_rows_reference(flat: torch.Tensor,
                               lanes: torch.Tensor) -> torch.Tensor:
    return flat.index_select(0, lanes)


def scatter_lane_rows_reference(flat: torch.Tensor, lanes: torch.Tensor,
                                rows: torch.Tensor,
                                skip_lane: int) -> torch.Tensor:
    """A masked index_copy_: rows aimed at `skip_lane` write that lane's
    own current row back, which leaves it as it was."""
    keep = (lanes != skip_lane)[:, None, None]
    flat.index_copy_(0, lanes.to(torch.int64),
                     torch.where(keep, rows, flat[skip_lane]))
    return flat


def gather_pos_rows_reference(pa: torch.Tensor, pv: torch.Tensor,
                              lanes: torch.Tensor) -> tuple:
    return (join_rows(pa.index_select(0, lanes)),
            join_rows(pv.index_select(0, lanes)))


def scatter_pos_rows_reference(pa: torch.Tensor, pv: torch.Tensor,
                               lanes: torch.Tensor, pa_blk: torch.Tensor,
                               pv_blk: torch.Tensor, skip_lane: int) -> tuple:
    scatter_lane_rows_reference(pa, lanes, split_rows(pa_blk), skip_lane)
    scatter_lane_rows_reference(pv, lanes, split_rows(pv_blk), skip_lane)
    return pa, pv


# ---------------------------------------------------------------------------
# the kernels' wrappers

def _check(flat: torch.Tensor, lanes: torch.Tensor, rows=None):
    if (flat.dtype != torch.int32 or flat.dim() != 3 or flat.shape[2] != LN
            or not flat.is_contiguous()):
        raise ValueError(f"flat: expected contiguous (S, SUB, {LN}) int32, "
                         f"got {tuple(flat.shape)} {flat.dtype}")
    if (lanes.dtype != torch.int32 or lanes.dim() != 1
            or not lanes.is_contiguous() or lanes.device != flat.device):
        raise ValueError(f"lanes: expected contiguous (W,) int32 on "
                         f"{flat.device}, got {tuple(lanes.shape)} "
                         f"{lanes.dtype} on {lanes.device}")
    if rows is not None:
        want = (lanes.shape[0],) + tuple(flat.shape[1:])
        if (rows.dtype != torch.int32 or tuple(rows.shape) != want
                or not rows.is_contiguous() or rows.device != flat.device):
            raise ValueError(f"rows: expected contiguous {want} int32 on "
                             f"{flat.device}, got {tuple(rows.shape)} "
                             f"{rows.dtype} on {rows.device}")
    dev = flat.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"row copies run on cuda or cpu, not {dev}")
    return dev


def gather_lane_rows(flat: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """flat: (S, SUB, LN) i32; lanes: (W,) i32 -> (W, SUB, LN) copy of the
    rows `flat[lanes[w]]`. CPU tensors take the plain version; CUDA
    tensors launch the B4 kernel or raise."""
    if _check(flat, lanes).type == "cpu":
        return gather_lane_rows_reference(flat, lanes)
    from kme_tpu_torch import native

    out = torch.empty((lanes.shape[0],) + tuple(flat.shape[1:]),
                      dtype=torch.int32, device=flat.device)
    native.launch_rowdma_gather(flat, lanes, out)
    _launched("gather")
    return out


def scatter_lane_rows(flat: torch.Tensor, lanes: torch.Tensor,
                      rows: torch.Tensor, skip_lane: int) -> torch.Tensor:
    """Write `rows[w]` into `flat[lanes[w]]` IN PLACE, dropping rows whose
    lane is `skip_lane`; returns `flat`. Lanes other than `skip_lane`
    must be distinct (the scheduler's one-message-per-lane step
    invariant; not checked, since that would wait for the card). CPU
    tensors take the plain version; CUDA tensors launch the B5 kernel or
    raise."""
    if _check(flat, lanes, rows).type == "cpu":
        return scatter_lane_rows_reference(flat, lanes, rows, skip_lane)
    from kme_tpu_torch import native

    native.launch_rowdma_scatter(flat, lanes, rows, skip_lane)
    _launched("scatter")
    return flat


def _check_pos(pa: torch.Tensor, pv: torch.Tensor, lanes: torch.Tensor,
               blks=()):
    dev = _check(pa, lanes)
    _check(pv, lanes)
    if pv.shape != pa.shape:
        raise ValueError(f"pv: expected the shape of pa {tuple(pa.shape)}, "
                         f"got {tuple(pv.shape)}")
    want = (lanes.shape[0], pa[0].numel() // 2)
    for name, b in zip(("pa_blk", "pv_blk"), blks):
        if (b.dtype != torch.int64 or tuple(b.shape) != want
                or not b.is_contiguous() or b.device != pa.device):
            raise ValueError(f"{name}: expected contiguous {want} int64 on "
                             f"{pa.device}, got {tuple(b.shape)} {b.dtype} "
                             f"on {b.device}")
    return dev


def gather_pos_rows(pa: torch.Tensor, pv: torch.Tensor,
                    lanes: torch.Tensor) -> tuple:
    """pa, pv: (S, SUB, LN) i32 planar position planes; lanes: (W,) i32 ->
    (pa_blk, pv_blk), the rows `lanes` of each joined to a (W, A) s64
    block (A = SUB * LN / 2). CPU tensors take the plain version; CUDA
    tensors launch the B4 kernel's (2, joined) instantiation or raise."""
    if _check_pos(pa, pv, lanes).type == "cpu":
        return gather_pos_rows_reference(pa, pv, lanes)
    from kme_tpu_torch import native

    shape = (lanes.shape[0], pa[0].numel() // 2)
    pa_blk = torch.empty(shape, dtype=torch.int64, device=pa.device)
    pv_blk = torch.empty(shape, dtype=torch.int64, device=pa.device)
    native.launch_pos_gather(pa, pv, lanes, pa_blk, pv_blk)
    _launched("gather_pos")
    return pa_blk, pv_blk


def scatter_pos_rows(pa: torch.Tensor, pv: torch.Tensor, lanes: torch.Tensor,
                     pa_blk: torch.Tensor, pv_blk: torch.Tensor,
                     skip_lane: int) -> tuple:
    """Split the (W, A) s64 blocks back into rows `lanes` of both planes IN
    PLACE, dropping rows whose lane is `skip_lane`; returns (pa, pv).
    Lanes other than `skip_lane` must be distinct, as for
    scatter_lane_rows. CPU tensors take the plain version; CUDA tensors
    launch the B5 kernel's (2, joined) instantiation or raise."""
    if _check_pos(pa, pv, lanes, (pa_blk, pv_blk)).type == "cpu":
        return scatter_pos_rows_reference(pa, pv, lanes, pa_blk, pv_blk,
                                          skip_lane)
    from kme_tpu_torch import native

    native.launch_pos_scatter(pa, pv, lanes, pa_blk, pv_blk, skip_lane)
    _launched("scatter_pos")
    return pa, pv
