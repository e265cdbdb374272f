"""The sharded lanes engine: the scan step over lane blocks, one CUDA
stream per shard.

The port of `kme_tpu/parallel/mesh.py`. The JAX package runs the step
under `shard_map` over the 'symbol' mesh axis; the port has no mesh to
map over, so the merges that the reference writes as collectives are
written out here:

- lane state (books, positions, seq, flags) is SHARDED: shard s owns the
  contiguous lanes [s*S_local, (s+1)*S_local) — its block of the
  session's state tensors, taken as views (`lane_block`), so what the
  shards write in place lands in the one state the session exports,
  snapshots and gauges;
- account state (balances, created flags), the counters, histograms,
  sticky error and fill log are REPLICATED (`REPLICATED`): one copy,
  which the shard steps only read. Each shard's step writes its dense
  balance delta, created flags, metric and histogram deltas and its
  non-NOP count into its own delta buffers; after the shards' streams
  are joined, the merge adds the summed deltas (exact: the scheduler
  keeps each step's accounts disjoint, so at most one shard contributes
  to an account), ORs the created flags, and buckets the summed count
  into the occupancy row, as the reference's `psum` before the bucket
  does. The step never changes the sticky error (the reference's `pmax`
  of an unchanged replicated value);
- barrier ops (payout/remove) run on the owning shard at its local lane;
  the other shards contribute zero.

The sharded path is always full width (no active-lane compaction, so no
row-copy kernel). Its outputs ride the window buffers at global lane
columns, so the chunk wrapper (`engine/lanes.py` `chunk_compaction`)
appends the fill log in global lane order, the order of the reference's
replicated log. On the card the whole sharded step — the fork onto the
shard streams, each shard's step, the join and the merge — is captured
into one CUDA graph by LaneSession, like the one-device step.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from kme_tpu_torch.engine import lanes as L

AXIS = "symbol"

# the replicated keys (the JAX package's `state_specs` P()); every other
# state key is sharded on the lane axis
REPLICATED = ("bal", "bal_used", "err", "metrics", "hist", "fillbuf",
              "filloff")


def local_config(cfg: L.LaneConfig, shards: int) -> L.LaneConfig:
    """The configuration of one shard's lane block."""
    if cfg.lanes % shards:
        raise ValueError(f"lanes {cfg.lanes} not divisible by "
                         f"{shards} shards")
    if cfg.width > 0 or cfg.pos_dma:
        raise ValueError("the sharded lanes engine is full width")
    return dataclasses.replace(cfg, lanes=cfg.lanes // shards)


def lane_block(cfg: L.LaneConfig, state: dict, shards: int, s: int) -> dict:
    """Shard s's view of a full-width state: its lanes' rows of the
    sharded tensors (contiguous views, written in place) and the
    replicated tensors themselves."""
    Sl, A = cfg.lanes // shards, cfg.accounts
    out = {}
    for k, v in state.items():
        if k in REPLICATED:
            out[k] = v
        elif k in L._POS_KEYS:      # flat (S*A,) at full width
            out[k] = v[s * Sl * A:(s + 1) * Sl * A]
        else:
            out[k] = v[s * Sl:(s + 1) * Sl]
    return out


def io_block(cfg: L.LaneConfig, io: dict, shards: int, s: int) -> dict:
    """Shard s's columns of the full-width window buffers (the step index
    is shared)."""
    Sl = cfg.lanes // shards
    out = {k: v[:, :, s * Sl:(s + 1) * Sl] for k, v in io.items()
           if k != "t"}
    out["t"] = io["t"]
    return out


class ShardedStep:
    """The port of `build_sharded_step`.

    step(state, io): ONE step of a window over `shards` lane blocks,
    with the one-device step's contract (engine/lanes.py
    `build_lane_step`), so `chunk_compaction` and LaneSession's graph
    capture take it in its place. On the card each shard's block runs on
    its own stream, forked from and joined back into the current stream
    (inside a capture too); on the CPU the blocks run one after
    another. The lane-block views and the delta buffers are bound to the
    state and window buffers at first use and again whenever one of
    their tensors is replaced."""

    def __init__(self, cfg: L.LaneConfig, shards: int, device) -> None:
        self.cfg = cfg
        self.shards = shards
        self.local_cfg = local_config(cfg, shards)
        self.device = torch.device(device)
        self.inner = L.build_lane_step(self.local_cfg, axis_name=AXIS)
        self.streams = ([torch.cuda.Stream(self.device)
                         for _ in range(shards)]
                        if self.device.type == "cuda" else None)
        self._key = None
        self._blocks: List[dict] = []
        self._ios: List[dict] = []
        self._thr = L.hist_thresholds(self.device)

    def _bind(self, state: dict, io: dict) -> None:
        key = tuple(v.data_ptr() for v in list(state.values())
                    + list(io.values()))
        if key == self._key:
            return
        self._blocks = [dict(lane_block(self.cfg, state, self.shards, s),
                             **L.make_shard_deltas(self.cfg, self.device))
                        for s in range(self.shards)]
        self._ios = [io_block(self.cfg, io, self.shards, s)
                     for s in range(self.shards)]
        self._key = key

    def __call__(self, state: dict, io: dict) -> None:
        self._bind(state, io)
        blocks = self._blocks
        if self.streams is None:
            for blk, bio in zip(blocks, self._ios):
                self.inner(blk, bio)
        else:
            cur = torch.cuda.current_stream(self.device)
            for st, blk, bio in zip(self.streams, blocks, self._ios):
                st.wait_stream(cur)
                with torch.cuda.stream(st):
                    self.inner(blk, bio)
            for st in self.streams:
                cur.wait_stream(st)
        merge_deltas(state, blocks, self._thr)
        io["t"].add_(1)


def merge_deltas(state: dict, blocks: List[dict], thr) -> None:
    """The step's cross-shard merge on the replicated state: balance
    deltas and counter deltas summed, created flags ORed, the summed
    non-NOP count bucketed into the occupancy row."""
    def total(k):
        return torch.stack([b[k] for b in blocks]).sum(0)

    state["bal"].add_(total("d_bal"))
    state["bal_used"].logical_or_(total("d_created") > 0)
    state["metrics"].add_(total("d_metrics"))
    state["hist"][:2].add_(total("d_hist"))
    occ = total("d_occ")
    state["hist"][L.HIST_OCCUPANCY].index_add_(
        0, L.hist_bucket(occ, thr), (occ > 0).to(torch.int64))


def build_sharded_chunk(cfg: L.LaneConfig, T: int, M: int,
                        step: ShardedStep):
    """The compact-I/O chunk (engine/lanes.py `chunk_compaction`) around
    the sharded step: messages scattered into the full-width window
    buffers, the outputs gathered back and the fills appended from them
    in global lane order."""
    return L.chunk_compaction(cfg, T, M, step)


def build_sharded_settle(cfg: L.LaneConfig, shards: int):
    """settle(state, global_lane, credit_size, mode) -> ok: the owning
    shard settles its local lane on its block; the others are called
    with lane -1 and contribute zero."""
    local_cfg = local_config(cfg, shards)
    S_local = local_cfg.lanes
    inner = L.build_barrier_ops(local_cfg, axis_name=AXIS)

    def settle(state, global_lane: int, credit_size: int, mode: int) -> bool:
        owner = global_lane // S_local
        oks = [inner(lane_block(cfg, state, shards, s),
                     global_lane % S_local if s == owner else -1,
                     credit_size, mode)
               for s in range(shards)]
        return any(oks)

    return settle
