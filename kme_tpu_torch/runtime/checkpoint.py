"""Checkpoint / resume: the durability story.

The reference gets durability from RocksDB-backed stores + Kafka
changelog topics; resume = Kafka Streams restoring store state and
continuing from the committed input offset
(the reference's KProcessor.java:30-49; commit :125).
Exactly-once is commented out (:29), so its guarantee is AT-LEAST-ONCE:
on crash, records after the last commit replay.

The TPU-native equivalent: an explicit `(state_pytree, input_offset)`
snapshot at a batch boundary (SURVEY.md §5). Because the engine is
deterministic, resume = load snapshot + replay the input tail, and the
replayed outputs are bit-identical — the same at-least-once contract
with replay bounded by the checkpoint interval instead of one record.

The exactly-once layer (bridge/broker.py fencing + idempotent produce)
upgrades that: every save accepts an additive ``extra`` meta dict — the
service stores its ``{"epoch", "out_seq"}`` produce-stamp cursor there —
and `snapshot_extra` reads it back on resume, so the replayed tail
re-produces with the SAME stamps and the broker suppresses it.

Snapshots are self-describing single files: every state array plus a
JSON `meta` blob (config, compaction width, shard count, input offset,
scheduler id-maps) in one .npz, written atomically (tmp + rename) and
named ckpt-<offset>.npz so the latest valid one wins; a torn or corrupt
file falls back to the previous snapshot.

The device fill log is intentionally NOT saved: at a batch boundary it
has been drained to the host and rewound (filloff == 0), so restore
recreates it as zeros.

A copy of `kme_tpu/runtime/checkpoint.py` for the port's sessions. The
file format — the `.npz` keys, dtypes and shapes, the JSON `meta`, the
sha256 content digest — is the JAX package's exactly, so a snapshot
written by either package restores into the other. The state comes off
the card once per snapshot, after the device has finished every queued
write to it (`_host_state`), and goes back onto the session's device
through the engines' canonical importers. The loaders take `device`
(default the card).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import List, Optional, Tuple

import numpy as np

from kme_tpu_torch import faults

_CKPT_RE = re.compile(r"^ckpt-(\d+)\.npz$")


def _keep_default() -> int:
    """Snapshot retention depth. Two is the bare minimum (newest + one
    fallback); the default keeps a deeper tail so several consecutive
    corrupt/torn snapshots still leave a valid restore point
    (kme-chaos tears AND bit-flips). KME_CKPT_KEEP / --checkpoint-keep
    override."""
    try:
        return max(1, int(os.environ.get("KME_CKPT_KEEP", "3")))
    except ValueError:
        return 3


class SnapshotCapacityError(ValueError):
    """The snapshot cannot restore into the requested capacity/engine
    config (a state migration, not a resume) — callers must NOT
    silently fall back to a fresh engine."""


_SKIP_KEYS = ("fillbuf",)
# arrays whose leading axis is the lane axis (stored in CANONICAL form:
# user lanes only — the compact path's scrap row is provably all-zero,
# so it is stripped at save and recreated at load; this makes snapshots
# portable across width/shard configurations)
_LANE_KEYS = ("slot_oid", "slot_aid", "slot_price", "slot_size",
              "slot_seq", "slot_used", "seq", "book_exists")
_POS_KEYS = ("pos_amt", "pos_avail")  # flat (S*A,) lane-major


def snapshot_path(ckpt_dir: str, offset: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt-{offset}.npz")


def _payload_digest(payload: dict) -> str:
    """sha256 over every array's dtype/shape/bytes (sorted key order,
    'digest' excluded) — the content integrity check _load_file
    verifies. A bit-flipped payload that still np.load-parses fails
    HERE instead of silently restoring wrong state."""
    h = hashlib.sha256()
    for k in sorted(payload):
        if k == "digest":
            continue
        arr = np.ascontiguousarray(np.asarray(payload[k]))
        h.update(k.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _atomic_savez(ckpt_dir: str, offset: int, payload: dict,
                  keep: Optional[int] = None) -> str:
    """THE durable snapshot write: content digest + tmp file + fsync +
    atomic rename + directory fsync + prune. Every .npz save path goes
    through here so the crash-safety sequence cannot fork."""
    payload = dict(payload)
    payload["digest"] = np.frombuffer(
        _payload_digest(payload).encode(), dtype=np.uint8)
    path = snapshot_path(ckpt_dir, offset)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(ckpt_dir)
    _post_write_faults(path)
    _prune(ckpt_dir, _CKPT_RE, keep=keep)
    return path


def _post_write_faults(path: str) -> None:
    """kme-chaos injection points: tear or bit-flip the snapshot that
    was just made durable (the load path must detect either and fall
    back to the previous snapshot)."""
    faults.damage_file("ckpt.torn", path)
    faults.damage_file("ckpt.bitflip", path)


def list_snapshots(ckpt_dir: str) -> List[Tuple[int, str]]:
    """(offset, path) pairs, newest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    out.sort(reverse=True)
    return out


def _synchronize(session) -> None:
    """Wait for every stream of the session's device: the compute
    stream's kernels write the state, and a snapshot must see all of
    them (the copy streams only stage inputs and fetch outputs, but a
    device-wide wait covers them too)."""
    dev = getattr(session, "device", None)
    if dev is not None and dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def save_session(ckpt_dir: str, session, offset: int,
                 keep: Optional[int] = None,
                 extra: Optional[dict] = None) -> str:
    """Snapshot `session` (a LaneSession) at input offset `offset`.
    Must be called at a batch boundary (the fill log drained)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _synchronize(session)
    # the canonical payload: user lanes, flat s64 positions (the
    # pos_dma planar rows joined back), every array but the fill log
    payload = dict(session.export_canonical())
    if int(payload["filloff"][0]) != 0:
        raise ValueError("snapshot requires a drained fill log "
                         "(call at a batch boundary)")
    sch = session.scheduler
    meta = {
        "version": 1,
        "kind": "lanes",
        "offset": int(offset),
        "cfg": dataclasses.asdict(session.cfg),
        "width": int(session.dev_cfg.width),
        "shards": int(session.shards),
        "aid_idx": sorted(sch.aid_idx.items()),
        "sid_lane": sorted(sch.sid_lane.items()),
        "oid_sid": sorted(sch.oid_sid.items()),
        "rr_lane": sch._rr_lane,
    }
    if extra:
        meta["extra"] = dict(extra)
    payload["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    return _atomic_savez(ckpt_dir, offset, payload, keep=keep)


def _fsync_dir(d: str) -> None:
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _prune(ckpt_dir: str, pattern, keep: Optional[int] = None) -> None:
    """Unlink all but the newest `keep` snapshots. keep=None uses the
    configured default (_keep_default) — deep enough that multi-step
    fallback past several corrupt snapshots still finds a valid one."""
    if keep is None:
        keep = _keep_default()
    keep = max(1, int(keep))
    cands = []
    for name in os.listdir(ckpt_dir):
        m = pattern.match(name)
        if m:
            cands.append((int(m.group(1)), name))
    cands.sort(reverse=True)
    for _, name in cands[keep:]:
        try:
            os.unlink(os.path.join(ckpt_dir, name))
        except OSError:
            pass


def _load_file(path: str):
    data = np.load(path)
    if "digest" in data.files:
        want = bytes(data["digest"]).decode()
        got = _payload_digest({k: data[k] for k in data.files})
        if got != want:
            raise ValueError(
                f"content digest mismatch in {path} (stored "
                f"{want[:12]}…, computed {got[:12]}…): corrupt snapshot")
    # pre-digest snapshots (older writers) load unverified
    meta = json.loads(bytes(data["meta"]).decode())
    # "lanes" and "seq" snapshots share the canonical payload layout
    # and restore into EITHER engine (cross-engine restore); "seqjava"
    # is the java-mode canonical form (runtime/javasnap.py), restorable
    # into SeqSession(compat='java') and convertible to/from the native
    # engine's dump
    if meta.get("version") != 1 or meta.get("kind") not in (
            "lanes", "seq", "seqjava"):
        raise ValueError(f"unsupported snapshot {path}")
    return data, meta


class _SessionError(Exception):
    """Building the session itself failed (no card, an unported
    topology): not a property of the snapshot, so the loaders re-raise
    the cause instead of falling back to an older file."""


def load_session(ckpt_dir: str, shards: Optional[int] = None,
                 width: Optional[int] = None, device="cuda"):
    """Restore the newest valid snapshot in `ckpt_dir` into a
    LaneSession on `device`.
    Returns (session, offset) or (None, 0) when no usable snapshot
    exists. A corrupt newest file (torn write) falls back to the next.
    `shards`/`width` override the snapshot's values (elastic restore
    onto a different compaction width — snapshots are canonical, so any
    combination restores bit-exactly)."""
    for offset, path in list_snapshots(ckpt_dir):
        try:
            return _restore_one(path, shards, width, device), offset
        except SnapshotCapacityError:
            raise          # operator error, not corruption: surface it
        except _SessionError as e:
            raise e.__cause__
        except Exception as e:  # torn/corrupt snapshot: fall back
            import sys

            print(f"kme_tpu_torch.checkpoint: skipping unreadable "
                  f"snapshot {path}: {e}", file=sys.stderr)
    return None, 0


def _restore_one(path: str, shards: Optional[int], width: Optional[int],
                 device="cuda"):
    """Restore one snapshot file into a live LaneSession (raises on any
    corruption — load_session falls back to the previous snapshot)."""
    from kme_tpu_torch.engine.lanes import LaneConfig
    from kme_tpu_torch.runtime.session import LaneSession

    data, meta = _load_file(path)
    if meta.get("kind") == "seqjava":
        raise SnapshotCapacityError(
            "java-mode snapshot cannot restore into the (fixed-mode) "
            "lanes engine — restore with load_seq_session into "
            "SeqConfig(compat='java') or convert to the native engine "
            "(runtime/javasnap.py)")
    if meta.get("kind") == "seq":  # cross-engine restore (canonical)
        mc = meta["cfg"]
        cfg = LaneConfig(lanes=int(mc["lanes"]), slots=int(mc["slots"]),
                         accounts=int(mc["accounts"]),
                         max_fills=int(mc["max_fills"]))
    else:
        cfg = LaneConfig(**meta["cfg"])
    use_shards = meta["shards"] if shards is None else shards
    use_width = meta["width"] if width is None else width
    canon = {k: np.asarray(data[k]) for k in data.files
             if k not in ("meta", "digest")}
    try:
        ses = LaneSession(cfg, shards=use_shards, width=use_width or 0,
                          device=device)
    except Exception as e:
        raise _SessionError(str(e)) from e
    # shape checks per array (a mismatch is a corrupt snapshot); the
    # metrics/hist counters of pre-observability snapshots and the seq
    # engine's form start from zeros
    ses.import_canonical(canon, {int(k): int(i) for k, i in meta["aid_idx"]},
                         {int(k): int(l) for k, l in meta["sid_lane"]},
                         {int(k): int(s) for k, s in meta["oid_sid"]},
                         int(meta["rr_lane"]))
    return ses


def save_seq_session(ckpt_dir: str, session, offset: int,
                     keep: Optional[int] = None,
                     extra: Optional[dict] = None) -> str:
    """Snapshot a SeqSession at input offset `offset` in the SAME
    canonical layout as lanes snapshots (slot_* / flat s64 positions /
    bal), so snapshots restore across ENGINES as well as across
    shard/width topologies."""
    from kme_tpu_torch.engine import seq as SQ

    _synchronize(session)
    if session.cfg.compat == "java":
        return _save_seqjava(ckpt_dir, session, offset, keep=keep,
                             extra=extra)
    os.makedirs(ckpt_dir, exist_ok=True)
    canon = SQ.export_canonical(session.cfg, session.state)
    r = session.router
    meta = {
        "version": 1,
        "kind": "seq",
        "offset": int(offset),
        "cfg": dataclasses.asdict(session.cfg),
        "metrics": [int(x) for x in session._metrics],
        "hist": [[int(x) for x in row] for row in session._hist],
        "aid_idx": sorted(r.aid_idx.items()),
        "sid_lane": sorted(r.sid_lane.items()),
        "oid_sid": sorted(r.oid_sid.items()),
        "rr_lane": 0,   # lanes-session cross-restore compatibility
        "width": 0,
        "shards": 1,
    }
    if extra:
        meta["extra"] = dict(extra)
    payload = {k: v for k, v in canon.items()
               if k != "metrics" and v is not None}
    payload["err"] = np.asarray(canon["err"])
    # lanes-session cross-restore expects the drained fill-log cursor
    payload["filloff"] = np.zeros(1, np.int64)
    payload["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    return _atomic_savez(ckpt_dir, offset, payload, keep=keep)


def _save_seqjava(ckpt_dir: str, session, offset: int,
                  keep: Optional[int] = None,
                  extra: Optional[dict] = None) -> str:
    """Snapshot a java-mode SeqSession: the canonical java form
    (runtime/javasnap.py) — flat 128-bit-key position arrays (Q11
    garbage keys included: they are parity-relevant state), resting
    orders with direction tags and bucket seq, balances, and the
    router id maps."""
    from kme_tpu_torch.runtime.javasnap import export_seqjava

    os.makedirs(ckpt_dir, exist_ok=True)
    snap = export_seqjava(session)
    meta = {
        "version": 1,
        "kind": "seqjava",
        "offset": int(offset),
        "cfg": dataclasses.asdict(session.cfg),
        "metrics": [int(x) for x in session._metrics],
        "hist": [[int(x) for x in row] for row in session._hist],
        "aid_idx": sorted(snap["aid_idx"].items()),
        "sid_lane": sorted(snap["sid_lane"].items()),
        "oid_sid": sorted(snap["oid_sid"].items()),
    }
    if extra:
        meta["extra"] = dict(extra)
    payload = {k: np.asarray(v) for k, v in snap.items()
               if k not in ("aid_idx", "sid_lane", "oid_sid")}
    payload["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    return _atomic_savez(ckpt_dir, offset, payload, keep=keep)


def _seqjava_snap_from_file(data, meta) -> dict:
    snap = {k: np.asarray(data[k]) for k in data.files if k != "meta"}
    snap["aid_idx"] = {int(k): int(v) for k, v in meta["aid_idx"]}
    snap["sid_lane"] = {int(k): int(v) for k, v in meta["sid_lane"]}
    snap["oid_sid"] = {int(k): int(v) for k, v in meta["oid_sid"]}
    return snap


def load_seq_session(ckpt_dir: str, cfg=None, device="cuda"):
    """Restore the newest valid snapshot into a SeqSession on `device`.
    `cfg` (a SeqConfig) sets the RESTORE topology — snapshots are
    canonical, so any slots >= the snapshot's depth works, and
    lanes-engine snapshots restore here too (cross-engine). Returns
    (session, offset) or (None, 0)."""
    for offset, path in list_snapshots(ckpt_dir):
        try:
            return _restore_seq_one(path, cfg, device), offset
        except SnapshotCapacityError:
            raise          # operator error, not corruption: surface it
        except _SessionError as e:
            raise e.__cause__
        except Exception as e:
            import sys

            print(f"kme_tpu_torch.checkpoint: skipping unreadable "
                  f"snapshot {path}: {e}", file=sys.stderr)
    return None, 0


def _seq_session(cfg, device):
    from kme_tpu_torch.runtime.seqsession import SeqSession

    try:
        return SeqSession(cfg, device=device)
    except Exception as e:
        raise _SessionError(str(e)) from e


def _restore_seq_one(path: str, cfg, device="cuda"):
    from kme_tpu_torch.engine import seq as SQ

    data, meta = _load_file(path)
    explicit_cfg = cfg is not None
    if meta["kind"] == "seqjava":
        from kme_tpu_torch.runtime.javasnap import import_seqjava

        if cfg is None:
            cfg = SQ.SeqConfig(**meta["cfg"])
        if cfg.compat != "java":
            raise SnapshotCapacityError(
                "java-mode snapshot requires SeqConfig(compat='java') "
                "(or conversion to the native engine, "
                "runtime/javasnap.py)")
        if explicit_cfg:
            # same contract as the fixed path: the device capacity
            # envelope must not change across a resume (a changed
            # slots/max_fills alters where the fatal java capacity
            # error trips mid-stream)
            n0 = int(meta["cfg"]["slots"])
            mf = int(meta["cfg"]["max_fills"])
            if cfg.slots != n0 or cfg.max_fills != mf:
                raise SnapshotCapacityError(
                    f"snapshot capacity (slots={n0}, max_fills={mf}) "
                    f"!= requested (slots={cfg.slots}, max_fills="
                    f"{cfg.max_fills}) — capacity changes need a "
                    f"state migration, not a resume")
        snap = _seqjava_snap_from_file(data, meta)
        try:
            dev = SQ.resolve_device(device)
        except Exception as e:
            raise _SessionError(str(e)) from e
        try:
            ses = import_seqjava(cfg, snap, dev)
        except ValueError as e:
            raise SnapshotCapacityError(str(e)) from e
        if "metrics" in meta:
            ses._metrics = np.asarray(meta["metrics"], np.int64)
        if "hist" in meta:
            ses._hist = np.asarray(meta["hist"], np.int64)
        return ses
    if cfg is not None and cfg.compat == "java":
        raise SnapshotCapacityError(
            "fixed-mode snapshot cannot restore into a java-mode "
            "session")
    if cfg is None:
        if meta["kind"] == "seq":
            cfg = SQ.SeqConfig(**meta["cfg"])
        else:  # a lanes snapshot: map the shared capacity fields
            mc = meta["cfg"]
            slots = -(-int(mc["slots"]) // 128) * 128
            cfg = SQ.SeqConfig(
                lanes=int(mc["lanes"]), slots=slots,
                accounts=-(-int(mc["accounts"]) // 128) * 128,
                max_fills=int(mc["max_fills"]),
                hbm_books=slots > 512)
    canon = {k: np.asarray(data[k]) for k in data.files if k != "meta"}
    canon.setdefault("err", np.int32(0))
    if explicit_cfg:
        # service resume: the matching ENVELOPE must not change across
        # a resume (the lanes/native paths enforce the same; deeper
        # books or a different max_fills alter reject behavior
        # mid-stream — that is a state migration, not a resume)
        n0 = int(np.asarray(canon["slot_oid"]).shape[2])
        mf = int(meta["cfg"].get("max_fills", cfg.max_fills))
        if cfg.slots != n0 or cfg.max_fills != mf:
            raise SnapshotCapacityError(
                f"snapshot envelope (slots={n0}, max_fills={mf}) != "
                f"requested (slots={cfg.slots}, max_fills="
                f"{cfg.max_fills}) — capacity changes need a state "
                f"migration, not a resume")
    ses = _seq_session(cfg, device)
    try:
        # every ValueError here is a config-vs-snapshot mismatch
        # (corruption surfaces earlier, in _load_file) — never treat it
        # as a skippable corrupt snapshot
        ses.state = SQ.import_canonical(cfg, canon, ses.device)
    except ValueError as e:
        raise SnapshotCapacityError(str(e)) from e
    if "metrics" in meta:
        ses._metrics = np.asarray(meta["metrics"], np.int64)
    if "hist" in meta:
        ses._hist = np.asarray(meta["hist"], np.int64)
    r = ses.router
    r.aid_idx = {int(k): int(i) for k, i in meta["aid_idx"]}
    r.sid_lane = {int(k): int(l) for k, l in meta["sid_lane"]}
    r.oid_sid = {int(k): int(s) for k, s in meta["oid_sid"]}
    return ses


# ---------------------------------------------------------------------------
# native-engine snapshots (text store dump + a JSON header line)

def save_native(ckpt_dir: str, engine, offset: int,
                keep: Optional[int] = None,
                extra: Optional[dict] = None) -> str:
    """Snapshot a NativeOracleEngine: JSON header (compat + envelope +
    offset + dump digest) on line one, then the store dump."""
    os.makedirs(ckpt_dir, exist_ok=True)
    dump = engine.dump_state()
    head = {
        "version": 1, "kind": "native", "offset": int(offset),
        "compat": "java" if engine.java else "fixed",
        "book_slots": engine.book_slots, "max_fills": engine.max_fills,
        "digest": hashlib.sha256(dump.encode("utf-8")).hexdigest(),
    }
    if extra:
        head["extra"] = dict(extra)
    header = json.dumps(head)
    path = os.path.join(ckpt_dir, f"ckpt-{offset}.nat")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(header + "\n")
        f.write(dump)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(ckpt_dir)
    _post_write_faults(path)
    _prune(ckpt_dir, re.compile(r"^ckpt-(\d+)\.nat$"), keep=keep)
    return path


def load_native(ckpt_dir: str):
    """Returns (engine, offset) or (None, 0); corrupt files fall back."""
    import sys

    from kme_tpu_torch.native.oracle import NativeOracleEngine

    if not os.path.isdir(ckpt_dir):
        return None, 0
    cands = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"^ckpt-(\d+)\.nat$", name)
        if m:
            cands.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    cands.sort(reverse=True)
    for offset, path in cands:
        try:
            with open(path, "r", encoding="utf-8") as f:
                header = json.loads(f.readline())
                if header.get("version") != 1 or header.get("kind") != "native":
                    raise ValueError("unsupported snapshot")
                dump = f.read()
                want = header.get("digest")
                if want is not None:  # pre-digest snapshots load as-is
                    got = hashlib.sha256(dump.encode("utf-8")).hexdigest()
                    if got != want:
                        raise ValueError(
                            f"content digest mismatch (stored "
                            f"{want[:12]}…, computed {got[:12]}…): "
                            f"corrupt snapshot")
                eng = NativeOracleEngine(header["compat"],
                                         book_slots=header["book_slots"],
                                         max_fills=header["max_fills"])
                eng.load_state(dump)
            return eng, offset
        except Exception as e:
            print(f"kme_tpu_torch.checkpoint: skipping unreadable "
                  f"snapshot {path}: {e}", file=sys.stderr)
    return None, 0


# ---------------------------------------------------------------------------
# oracle-engine snapshots (the scalar replica is plain host state)

def save_oracle(ckpt_dir: str, oracle, offset: int,
                keep: Optional[int] = None,
                extra: Optional[dict] = None) -> str:
    """The engine is pickled to bytes FIRST so the blob can carry a
    sha256 of exactly those bytes — load verifies the digest before
    unpickling, so a bit-flip that still pickle-parses is caught."""
    import pickle

    os.makedirs(ckpt_dir, exist_ok=True)
    engine_pkl = pickle.dumps(oracle)
    path = os.path.join(ckpt_dir, f"ckpt-{offset}.pkl")
    tmp = path + ".tmp"
    blob = {"version": 1, "kind": "oracle", "offset": int(offset),
            "engine_pkl": engine_pkl,
            "digest": hashlib.sha256(engine_pkl).hexdigest()}
    if extra:
        blob["extra"] = dict(extra)
    with open(tmp, "wb") as f:
        pickle.dump(blob, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(ckpt_dir)
    _post_write_faults(path)
    _prune(ckpt_dir, re.compile(r"^ckpt-(\d+)\.pkl$"), keep=keep)
    return path


def _port_unpickler(f):
    """An Unpickler that resolves the JAX package's classes to the
    port's copies (`kme_tpu.oracle.engine.OracleEngine` ->
    `kme_tpu_torch.oracle.engine.OracleEngine`), so an oracle snapshot
    either package wrote loads here without importing `kme_tpu`."""
    import pickle

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "kme_tpu" or module.startswith("kme_tpu."):
                module = "kme_tpu_torch" + module[len("kme_tpu"):]
            return super().find_class(module, name)

    return _Unpickler(f)


def load_oracle_file(path: str):
    """Restore ONE oracle snapshot file (digest-verified). Raises on
    corruption — callers own the fallback-to-older decision."""
    import io

    with open(path, "rb") as f:
        blob = _port_unpickler(f).load()
    if blob.get("version") != 1 or blob.get("kind") != "oracle":
        raise ValueError("unsupported snapshot")
    if "engine_pkl" in blob:
        got = hashlib.sha256(blob["engine_pkl"]).hexdigest()
        if got != blob.get("digest"):
            raise ValueError(
                f"content digest mismatch (stored "
                f"{str(blob.get('digest'))[:12]}…, computed "
                f"{got[:12]}…): corrupt snapshot")
        return _port_unpickler(io.BytesIO(blob["engine_pkl"])).load()
    return blob["engine"]   # pre-digest snapshot format


def load_oracle(ckpt_dir: str):
    """Returns (oracle, offset) or (None, 0)."""
    import sys

    if not os.path.isdir(ckpt_dir):
        return None, 0
    cands = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"^ckpt-(\d+)\.pkl$", name)
        if m:
            cands.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    cands.sort(reverse=True)
    for offset, path in cands:
        try:
            return load_oracle_file(path), offset
        except Exception as e:
            print(f"kme_tpu_torch.checkpoint: skipping unreadable "
                  f"snapshot {path}: {e}", file=sys.stderr)
    return None, 0


def restore_seq_snapshot(path: str, cfg=None, device="cuda"):
    """Restore ONE .npz snapshot file (lanes/seq/seqjava canonical
    form) into a SeqSession on `device`. Raises on corruption or
    capacity mismatch — the offset-addressed loaders use this to
    restore a SPECIFIC anchor instead of the newest snapshot."""
    try:
        return _restore_seq_one(path, cfg, device)
    except _SessionError as e:
        raise e.__cause__


# ---------------------------------------------------------------------------
# cross-kind snapshot metadata (the exactly-once produce-stamp cursor)

_ALL_SNAP_RES = (_CKPT_RE,
                 re.compile(r"^ckpt-(\d+)\.nat$"),
                 re.compile(r"^ckpt-(\d+)\.pkl$"))


def snapshot_extra(ckpt_dir: str, offset: int) -> dict:
    """The additive ``extra`` meta dict stored with the snapshot at
    exactly `offset` (any snapshot kind); {} when absent or unreadable.
    The caller already loaded the snapshot itself, so failures here
    degrade to an empty cursor (epoch 0 / out_seq 0), which the broker's
    recovered watermark still keeps duplicate-free."""
    npz = snapshot_path(ckpt_dir, offset)
    if os.path.exists(npz):
        try:
            data = np.load(npz)
            meta = json.loads(bytes(data["meta"]).decode())
            return dict(meta.get("extra") or {})
        except Exception:
            return {}
    nat = os.path.join(ckpt_dir, f"ckpt-{offset}.nat")
    if os.path.exists(nat):
        try:
            with open(nat, "r", encoding="utf-8") as f:
                header = json.loads(f.readline())
            return dict(header.get("extra") or {})
        except Exception:
            return {}
    pkl = os.path.join(ckpt_dir, f"ckpt-{offset}.pkl")
    if os.path.exists(pkl):
        try:
            with open(pkl, "rb") as f:
                blob = _port_unpickler(f).load()
            return dict(blob.get("extra") or {})
        except Exception:
            return {}
    return {}


def all_snapshots(ckpt_dir: str) -> List[Tuple[int, str]]:
    """(offset, path) pairs across ALL snapshot kinds (.npz/.nat/.pkl),
    newest first. The offset-addressed restore path (telemetry/xray.py)
    walks this to find the nearest anchor <= a target offset; ties at
    the same offset sort .pkl > .npz > .nat so the exact-state oracle
    snapshot wins when several kinds exist."""
    if not os.path.isdir(ckpt_dir):
        return []
    rank = {".pkl": 2, ".npz": 1, ".nat": 0}
    out = []
    for name in os.listdir(ckpt_dir):
        for pat in _ALL_SNAP_RES:
            m = pat.match(name)
            if m:
                ext = os.path.splitext(name)[1]
                out.append((int(m.group(1)), rank.get(ext, 0),
                            os.path.join(ckpt_dir, name)))
                break
    out.sort(reverse=True)
    return [(off, path) for off, _r, path in out]


def oldest_retained_offset(ckpt_dir: str) -> Optional[int]:
    """Smallest snapshot offset still on disk (any kind), or None when
    there are no snapshots. The journal's retention guard
    (telemetry/journal.py): a rotated journal segment may only be
    pruned once every event in it is OLDER than this — a standby
    restoring the oldest snapshot must still be able to replay to the
    tip."""
    if not os.path.isdir(ckpt_dir):
        return None
    oldest = None
    for name in os.listdir(ckpt_dir):
        for pat in _ALL_SNAP_RES:
            m = pat.match(name)
            if m:
                off = int(m.group(1))
                if oldest is None or off < oldest:
                    oldest = off
                break
    return oldest
