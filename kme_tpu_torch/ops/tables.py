"""Dense associative tables — the port of `kme_tpu/ops/tables.py`.

The reference's five RocksDB stores (KProcessor.java:30-49) become
fixed-capacity slot arrays: a lookup is one masked `==` over the key
column and an argmax for the first hit, an insert takes the first free
slot, a delete clears the used bit. Capacity overflow is reported by the
`ok` flag, which the caller turns into a sticky error.

Every function takes and returns tensors on the tables' device and reads
nothing back to the host. Indices are int64 (torch's index dtype; the
JAX package returns int32 with the same values). Slot 0 is a real slot:
"not found" is the separate boolean, so a caller gates every gather and
scatter on it.

`torch.argmax` takes no bool tensor, so hit masks are cast to int32
first; it returns the first of several maxima on the CPU and on CUDA,
which is the tie rule the reference relies on (the first free slot, the
one used slot with a key).
"""

from __future__ import annotations

import torch

_I32 = torch.int32


def _first(mask: torch.Tensor):
    """(index of the first True, any True) of a 1-D bool mask."""
    return torch.argmax(mask.to(_I32)), mask.any()


def find(keys, used, k):
    """Index of the used slot holding key `k` -> (idx, found).

    Keys are unique among used slots (put_idx never duplicates), so the
    first hit is THE slot."""
    return _first(used & (keys == k))


def find2(keys_a, keys_b, used, ka, kb):
    """Pair-key lookup (UUID-keyed stores: positions (aid, sid),
    KProcessor.java:418-425)."""
    return _first(used & (keys_a == ka) & (keys_b == kb))


def alloc(used):
    """First free slot -> (idx, ok). ok=False means the table is full
    (capacity overflow — a host-visible error)."""
    return _first(~used)


def put_idx(keys, used, k):
    """Slot to write key `k` into: the existing slot if present, else a
    fresh one -> (idx, ok). Mirrors map.put upsert semantics."""
    idx, found = find(keys, used, k)
    fresh, ok = alloc(used)
    return torch.where(found, idx, fresh), found | ok


def put2_idx(keys_a, keys_b, used, ka, kb):
    """Pair-key upsert slot -> (idx, ok)."""
    idx, found = find2(keys_a, keys_b, used, ka, kb)
    fresh, ok = alloc(used)
    return torch.where(found, idx, fresh), found | ok


def delete_at(used, idx, present):
    """Clear slot `idx` of `used` in place when `present`; no-op
    otherwise. Returns `used`. The slot's other columns may be left
    stale — `used` alone defines liveness."""
    i = idx.reshape(1)
    keep = used.index_select(0, i) & ~present.reshape(1)
    return used.index_put_((i,), keep)
