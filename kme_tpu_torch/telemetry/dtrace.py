"""Cluster-wide distributed tracing: deterministic per-order waterfalls
across front, groups, transfer legs and merge (kme-torch-trace --cluster), and
the aggregated cluster SLO plane (kme-torch-agg).

The port's copy of `kme_tpu/telemetry/dtrace.py`, single-leader part:
the trace ids (bit-identical, with a private copy of the front's
splitmix64 finalizer), span collection, waterfalls, Chrome trace docs
and the kme-torch-agg aggregation. `route_map`, `stitch` and
`stitch_state_root` re-run the multi-leader front's `GroupRouter`,
which the port does not have yet: they raise naming it.

Dapper's model (Sigelman et al. 2010 — PAPERS.md) is a tree of spans
joined by a trace id that is MINTED at the edge and CARRIED through
every hop. This repo grafts that model onto its replay-exact identity
discipline instead of carrying ids end to end:

- **Identity, not clocks.** A trace id is a pure splitmix64 mix of the
  order's durable identity — (input-stream offset, aid, oid) — never a
  wall clock or RNG draw (`kme-lint` KME-D001/D002 enforce this scope).
  A crash-replay that regenerates the same input prefix regenerates the
  SAME trace ids, so a waterfall stitched post-mortem is identical
  before and after a failover.

- **Two id spaces, one join.** The front's global id is
  `trace_id(off, aid, oid)` over the GLOBAL input offset. A serving
  group only knows its LOCAL broker offset, so its spans carry
  `local_tid(group, local_off)`. The stitcher re-runs the deterministic
  `GroupRouter` over the front input (route_map) to rebuild the global
  off -> (group, local index) map — including the injected transfer
  legs, whose emission order fixes their kinds (home debit =
  xfer_reserve, symbol credit = xfer_settle) — and joins the two spaces
  offline. Parent/child linkage is therefore a STITCH-time product;
  services never need the global id (their spans set ptid=0).

- **Carried ids are advisory.** The 80-byte FLAG_TID wire frame, the
  TCP "tid" produce key and Record.tid let a CLIENT thread its own
  correlation id through the stack (kme-torch-loadgen stamps
  `client_trace_id`). Those ids are transport metadata: they do not
  survive a broker-log reload and are never used as the stitch key.

Span sources, per group directory (chaos/supervise layout
`<state-root>/group{k}/state/`):

- "span" journal events (kme-torch-serve --trace-spans): ingress/plan/device/
  produce with real stage bounds;
- "lat" journal events as a fallback — the same stage durations, spans
  synthesized here;
- front_accept/route (+ merge) spans are synthesized by the stitcher
  when no front trace journal recorded them: the split and the merge
  are deterministic functions, not runtime hops, so their spans mark
  positions, zero-width (`synthetic: true`).

Failover replay segments are deduplicated by the durable key
(group, local_off, kind) — first occurrence wins — mirroring how the
broker dedups (epoch, out_seq). A promoted standby CONTINUES an order's
spans (a gap during the outage), it never forks a second waterfall.

The SLO plane (aggregate/kme-torch-agg) merges per-group /metrics.json
snapshots: latency histograms are summed at the raw LAT_BOUNDS bucket
level, so cluster quantiles are EXACT merged quantiles, never a
quantile-of-quantiles estimate. p99 exemplars (registry exemplars, the
service's slowest recent orders) resolve back to waterfalls via
`kme-torch-trace --order AID:OID`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from kme_tpu_torch.telemetry.journal import SPAN_KINDS  # noqa: F401
from kme_tpu_torch.telemetry.registry import LAT_N_BUCKETS, LatencyHistogram

# distinct salts keep the three id spaces (global trace, group-local
# span join key, client-carried correlation) from colliding
TRACE_SALT = 0x44545243      # "DTRC"
LOCAL_SALT = 0x4C4F434C      # "LOCL"
CLIENT_SALT = 0x434C4E54     # "CLNT"
_MASK63 = (1 << 63) - 1      # ids stay positive int64 (journal packs <q)
_MASK = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64 finalizer: a copy of the multi-leader front's
    (`kme_tpu/bridge/front.py` `_mix64`, itself the twin of mix64 in its
    native router). The ids below must stay bit-identical to the JAX
    package's."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def _needs_front(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} re-runs the multi-leader front's GroupRouter, which "
        f"needs the JAX package's bridge/front.py; kme_tpu_torch does not "
        f"have it yet (ROADMAP.md, Queue A item 6)")


def _tid_mix(salt: int, a: int, b: int, c: int) -> int:
    """Three-word splitmix64 combine, folded to a positive nonzero
    int64 (0 is the wire's "no trace id"). Pure: no clock, no RNG —
    the whole point is that a crash-replay re-derives the same id."""
    z = _mix64(salt ^ _mix64(a & ((1 << 64) - 1)))
    z = _mix64(z ^ _mix64(b & ((1 << 64) - 1)))
    z = _mix64(z ^ _mix64(c & ((1 << 64) - 1)))
    z &= _MASK63
    return z or 1


def trace_id(off: int, aid: int, oid: int) -> int:
    """The order's GLOBAL trace id: minted from its durable identity in
    the front's input stream (global offset + aid + oid)."""
    return _tid_mix(TRACE_SALT, off, aid, oid)


def local_tid(group: int, off: int) -> int:
    """A serving group's span join key: (group ordinal, group-local
    broker offset). This is what `--trace-spans` journals; the stitcher
    maps it back to the global trace via route_map."""
    return _tid_mix(LOCAL_SALT, group, off, 0)


def child_tid(parent: int, leg: int) -> int:
    """Deterministic child id for the leg-th front-injected line of a
    traced order (transfer legs, balance broadcasts)."""
    return _tid_mix(TRACE_SALT, parent, leg, 1)


def client_trace_id(seq: int, aid: int, oid: int) -> int:
    """The ADVISORY id a client stamps into the 80-byte FLAG_TID frame
    (or the TCP "tid" produce key): minted from the client's own stable
    identity (its out_seq counter + the order fields), so reconnects
    and retries re-stamp the same id."""
    return _tid_mix(CLIENT_SALT, seq, aid, oid)


def _mix64_np(z):
    """Vectorized splitmix64 finalizer over a numpy uint64 array —
    bit-identical to _mix64 (uint64 arithmetic wraps mod 2^64
    exactly like the scalar's explicit masking)."""
    import numpy as np

    z = z + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def client_trace_ids(seq0: int, aids, oids) -> List[int]:
    """client_trace_id over a whole batch (seq0, seq0+1, ...),
    vectorized: the binary send path mints thousands of ids per batch
    and the scalar's six Python splitmix rounds per record would
    dominate the ingress cost. Bit-identical to the scalar."""
    import numpy as np

    n = len(aids)
    seqs = np.arange(seq0, seq0 + n, dtype=np.int64).astype(np.uint64)
    a = np.asarray(aids, dtype=np.int64).astype(np.uint64)
    b = np.asarray(oids, dtype=np.int64).astype(np.uint64)
    z = _mix64_np(np.uint64(CLIENT_SALT) ^ _mix64_np(seqs))
    z = _mix64_np(z ^ _mix64_np(a))
    z = _mix64_np(z ^ _mix64_np(b))
    out = (z & np.uint64(_MASK63)).astype(np.int64)
    out[out == 0] = 1
    return out.tolist()


# ---------------------------------------------------------------------------
# route map: global input -> (group, local index) + injected legs


def route_map(lines: Sequence[str], ngroups: int,
              transfers: bool = True, prefund: int = 8):
    """Where every input line's rows landed after the deterministic
    front split (group, local index, injected legs). Needs the front."""
    raise _needs_front("route_map")


# ---------------------------------------------------------------------------
# span collection (journal readers + lat fallback + replay dedup)

_STAGES = ("ingress", "plan", "device", "produce")


def _spans_from_lat(ev: dict, group: int) -> List[dict]:
    """Synthesize the four service-stage spans from one "lat" event:
    same stage numbers, absolute bounds anchored at the event's commit
    stamp (ts == produce-visible for the batch)."""
    off = ev.get("off", -1)
    e2e = int(ev.get("e2e_us", 0))
    t_arr = int(ev.get("ts", 0)) - e2e
    tid = local_tid(group, off)
    bounds = []
    t = t_arr
    for k, dur in (("ingress", ev.get("in_us", 0)),
                   ("plan", ev.get("plan_us", 0)),
                   ("device", ev.get("dev_us", 0)),
                   ("produce", ev.get("prod_us", 0))):
        d = max(0, int(dur))
        bounds.append({"e": "span", "kind": k, "g": group, "off": off,
                       "oid": ev.get("oid", 0), "tid": tid, "ptid": 0,
                       "t0": t, "t1": t + d, "aid": 0, "li": -1,
                       "seq": ev.get("seq", 0)})
        t += d
    return bounds


def collect_group_spans(events: Iterable[dict], group: int
                        ) -> Dict[Tuple[int, str], dict]:
    """One group's journal events -> {(local_off, kind): span}, replay
    segments deduplicated (first occurrence by journal order wins — the
    same convention the broker applies to (epoch, out_seq) stamps).
    Prefers real "span" events; synthesizes from "lat" only for
    (off, stage) pairs no span event covered."""
    spans: Dict[Tuple[int, str], dict] = {}
    lat_fallback: Dict[Tuple[int, str], dict] = {}
    for ev in events:
        e = ev.get("e")
        if e == "span":
            key = (ev.get("off", -1), ev.get("kind"))
            if key not in spans:
                spans[key] = dict(ev, g=group)
        elif e == "lat":
            for sp in _spans_from_lat(ev, group):
                key = (sp["off"], sp["kind"])
                if key not in lat_fallback:
                    lat_fallback[key] = sp
    for key, sp in lat_fallback.items():
        if key not in spans:
            spans[key] = sp
    return spans


def discover_groups(state_root: str) -> List[Tuple[int, str]]:
    """[(k, groupdir)] for every `group{k}` child of a chaos/cluster run
    directory, ordered by k."""
    out = []
    try:
        names = os.listdir(state_root)
    except OSError:
        return []
    for name in names:
        if name.startswith("group") and name[5:].isdigit():
            p = os.path.join(state_root, name)
            if os.path.isdir(p):
                out.append((int(name[5:]), p))
    return sorted(out)


# ---------------------------------------------------------------------------
# stitching


def stitch(lines: Sequence[str],
           group_events: Dict[int, List[dict]],
           ngroups: int, transfers: bool = True, prefund: int = 8,
           front_events: Optional[List[dict]] = None) -> dict:
    """Merge per-group journals into per-order cluster waterfalls (the
    doc `find_order`, `waterfall_text` and `chrome_trace_doc` read).
    Needs the front."""
    raise _needs_front("stitch")


def stitch_state_root(state_root: str, input_path: Optional[str] = None,
                      transfers: bool = True, prefund: int = 8) -> dict:
    """Stitch a multi-leader run directory. Needs the front."""
    raise _needs_front("stitch_state_root")


def find_order(doc: dict, spec: str) -> Optional[dict]:
    """Resolve `--order AID:OID` (or a bare trace id) against a
    stitched doc."""
    if ":" in spec:
        aid_s, _, oid_s = spec.partition(":")
        aid, oid = int(aid_s), int(oid_s)
        for o in doc["orders"]:
            if o["aid"] == aid and o["oid"] == oid:
                return o
        return None
    tid = int(spec, 0)
    for o in doc["orders"]:
        if o["tid"] == tid or o["off"] == tid:
            return o
    # exemplars carry the group-LOCAL span join key (the service never
    # sees the global front offset) — resolve those too
    for o in doc["orders"]:
        if tid in o.get("ltids", ()):
            return o
    return None


# ---------------------------------------------------------------------------
# rendering: per-order text waterfall + Chrome trace


def waterfall_text(order: dict, width: int = 48) -> str:
    """One order's cluster waterfall as aligned text: span rows with
    group, absolute offsets and a proportional bar."""
    t0, t1 = order["t0"], max(order["t1"], order["t0"] + 1)
    span_total = t1 - t0
    lines = [f"order aid={order['aid']} oid={order['oid']} "
             f"off={order['off']} tid=0x{order['tid']:016x} "
             f"group=g{order['g']} "
             f"{'complete' if order['complete'] else 'PARTIAL'} "
             f"e2e={span_total}us"]
    for sp in order["spans"]:
        rel0 = max(0, sp["t0"] - t0)
        dur = max(0, sp["t1"] - sp["t0"])
        a = min(width - 1, int(width * rel0 / span_total))
        b = min(width, max(a + 1, int(width * (rel0 + dur)
                                      / span_total)))
        bar = " " * a + "#" * (b - a) + " " * (width - b)
        where = f"g{sp['g']}" if sp.get("g", -1) >= 0 else "--"
        tag = " (syn)" if sp.get("synthetic") else ""
        lines.append(f"  {sp['kind']:>12} {where:>3} |{bar}| "
                     f"+{rel0:>8}us {dur:>8}us{tag}")
    return "\n".join(lines)


def chrome_trace_doc(doc: dict) -> dict:
    """Chrome trace-event JSON ({"traceEvents": [...]}, chrome://tracing
    / Perfetto): one process row per group (front/merge on pid 0), one
    "X" slice per span, flow arrows (s/f, bp:"e") threading each
    order's spans across groups so the cross-shard hops draw as
    arrows."""
    evs: List[dict] = []
    meta_done = set()

    def _meta(pid, name):
        if pid not in meta_done:
            meta_done.add(pid)
            evs.append({"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_name",
                        "args": {"name": name}})

    _meta(0, "front/merge")
    for o in doc["orders"]:
        flow_id = f"0x{o['tid']:x}"
        prev_pid = None
        for sp in o["spans"]:
            g = sp.get("g", -1)
            pid = 0 if g < 0 else g + 1
            if pid:
                _meta(pid, f"group{g}")
            ts = sp["t0"]
            dur = max(1, sp["t1"] - sp["t0"])
            evs.append({"ph": "X", "pid": pid, "tid": o["off"],
                        "ts": ts, "dur": dur, "name": sp["kind"],
                        "cat": "kme",
                        "args": {"tid": f"0x{sp['tid']:x}",
                                 "ptid": f"0x{sp.get('ptid', 0):x}",
                                 "oid": o["oid"], "aid": o["aid"],
                                 "off": o["off"]}})
            if prev_pid is not None and pid != prev_pid:
                evs.append({"ph": "s", "pid": prev_pid,
                            "tid": o["off"], "ts": ts, "cat": "flow",
                            "name": "hop", "id": flow_id})
                evs.append({"ph": "f", "pid": pid, "tid": o["off"],
                            "ts": ts, "cat": "flow", "name": "hop",
                            "id": flow_id, "bp": "e"})
            prev_pid = pid
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# cluster aggregation (kme-torch-agg): the SLO plane


def merge_latencies(snaps: Sequence[Tuple[str, dict]]) -> dict:
    """Sum per-source latency histograms at the raw bucket level and
    recompute quantiles from the MERGED counts — exact, because every
    LatencyHistogram shares the fixed LAT_BOUNDS layout (the snapshot's
    "buckets" key, registry.py)."""
    merged: Dict[str, List[int]] = {}
    for _name, snap in snaps:
        for lname, lat in (snap.get("latencies") or {}).items():
            counts = lat.get("buckets")
            if not counts or len(counts) != LAT_N_BUCKETS:
                continue
            acc = merged.setdefault(lname, [0] * LAT_N_BUCKETS)
            for i, c in enumerate(counts):
                acc[i] += int(c)
    out = {}
    for lname, counts in merged.items():
        total = sum(counts)
        out[lname] = {
            "count": total,
            "p50_ms": round(LatencyHistogram._quantile_from(
                counts, total, 0.5) * 1e3, 3),
            "p90_ms": round(LatencyHistogram._quantile_from(
                counts, total, 0.9) * 1e3, 3),
            "p99_ms": round(LatencyHistogram._quantile_from(
                counts, total, 0.99) * 1e3, 3),
            "p999_ms": round(LatencyHistogram._quantile_from(
                counts, total, 0.999) * 1e3, 3),
            "buckets": counts,
        }
    return out


def _burn_rate(counts: Sequence[int], threshold_s: float,
               budget: float) -> Optional[float]:
    """SLO burn rate from merged buckets: (bad fraction) / (error
    budget). >1.0 burns the budget faster than the SLO allows. Bucket-
    conservative like LatencyHistogram.count_over."""
    import bisect

    from kme_tpu_torch.telemetry.registry import LAT_BOUNDS

    total = sum(counts)
    if total <= 0 or budget <= 0:
        return None
    i = bisect.bisect_left(LAT_BOUNDS, threshold_s)
    bad = sum(counts[i + 1:])
    return round((bad / total) / budget, 4)


def aggregate(snaps: Sequence[Tuple[str, dict]],
              slo_ms: Optional[float] = None,
              slo_target: float = 0.999,
              stale: Optional[dict] = None) -> dict:
    """The cluster SLO plane from N scraped /metrics.json snapshots
    (front + every group). Returns:

    - "e2e": merged cluster end-to-end latency (lat_e2e — front
      admission stamp to produce-visible; the merge itself is a
      deterministic sort, so produce-visible IS merge-visible),
      plus every other merged latency family;
    - "slo": global burn rate against (slo_ms, slo_target) when given;
    - "per_group": one row per source — e2e p99, input lag, overload
      state, shed count, imbalance gauges — degraded rows ("up": False)
      for sources that could not be scraped; rows named in `stale`
      (source -> {"age_s", "intervals", "sample_seq"}) additionally
      carry "stale": True — scraped fine, but the heartbeat's
      sample_seq/mtime has not advanced within 3 write intervals, so
      the numbers describe a frozen writer, not the present;
    - "exemplars": the slowest-order exemplars across all sources,
      worst first (each resolves to a waterfall via
      `kme-torch-trace --order AID:OID`)."""
    lat = merge_latencies([(n, s) for n, s in snaps if s])
    doc: dict = {"sources": len(snaps), "latencies": lat,
                 "e2e": lat.get("lat_e2e")}
    if slo_ms is not None and "lat_e2e" in lat:
        doc["slo"] = {
            "threshold_ms": slo_ms, "target": slo_target,
            "burn_rate": _burn_rate(lat["lat_e2e"]["buckets"],
                                    slo_ms * 1e-3, 1.0 - slo_target)}
    rows = []
    exemplars: List[dict] = []
    for name, snap in snaps:
        if not snap:
            rows.append({"source": name, "up": False})
            continue
        g = snap.get("gauges") or {}
        c = snap.get("counters") or {}
        lats = snap.get("latencies") or {}
        row = {"source": name, "up": True,
               "e2e_p99_ms": (lats.get("lat_e2e") or {}).get("p99_ms"),
               "orders": (lats.get("lat_e2e") or {}).get("count", 0),
               "overload_state": g.get("overload_state"),
               "shed": g.get("overload_rejects", 0)}
        if stale and name in stale:
            row["stale"] = True
            row["hb_age_s"] = stale[name].get("age_s")
            row["hb_intervals"] = stale[name].get("intervals")
            row["hb_sample_seq"] = stale[name].get("sample_seq")
            if stale[name].get("events_frozen"):
                # the control-plane event recorder wedged while the
                # heartbeat kept advancing (events_lag_bytes > 0):
                # the timeline describes the past, flag it loudly
                row["events_frozen"] = True
                row["events_lag_bytes"] = stale[name].get(
                    "events_lag_bytes")
        for k, v in g.items():
            if k.startswith("group") and (k.endswith("_lag")
                                          or k.endswith("_imbalance")):
                row[k] = v
        for k in ("cross_shard_transfers_total",
                  "transfer_shortfall_total"):
            if k in c:
                row[k] = c[k]
        if "feed_subscribers" in g:
            # feed-tier source (kme-feed heartbeat): fan-out health
            # rides the same per-source row; extras render generically
            delivered = c.get("feed_delivered_total", 0)
            dropped = c.get("feed_conflated_frames_total", 0)
            offered = delivered + dropped
            row["feed_subs"] = g["feed_subscribers"]
            row["feed_delivered"] = delivered
            row["feed_conflation"] = (round(dropped / offered, 4)
                                      if offered else 0.0)
            fl = lats.get("feed_lag") or {}
            if fl:
                row["feed_lag_p50_ms"] = fl.get("p50_ms")
                row["feed_lag_p99_ms"] = fl.get("p99_ms")
        rows.append(row)
        for ex in snap.get("exemplars") or ():
            exemplars.append(dict(ex, source=name))
    exemplars.sort(key=lambda e: -int(e.get("e2e_us", 0)))
    doc["per_group"] = rows
    doc["exemplars"] = exemplars[:16]
    return doc


def load_snapshots(paths: Sequence[str]) -> List[Tuple[str, dict]]:
    """(name, snapshot) per path; unreadable/undecodable sources come
    back as (name, None) so the aggregate renders a degraded row
    instead of dying."""
    out: List[Tuple[str, dict]] = []
    for p in paths:
        try:
            with open(p) as f:
                out.append((p, json.load(f)))
        except (OSError, ValueError):
            out.append((p, None))
    return out


def render_agg(doc: dict) -> str:
    """kme-torch-agg's human view: cluster quantiles, SLO burn, the per-group
    table, and resolvable exemplars."""
    lines = [f"cluster: {doc['sources']} sources"]
    e2e = doc.get("e2e")
    if e2e:
        lines.append(
            f"  e2e (front admission -> merge visible), "
            f"{e2e['count']} orders: p50={e2e['p50_ms']}ms "
            f"p90={e2e['p90_ms']}ms p99={e2e['p99_ms']}ms "
            f"p999={e2e['p999_ms']}ms")
    slo = doc.get("slo")
    if slo:
        br = slo.get("burn_rate")
        lines.append(
            f"  SLO {slo['threshold_ms']}ms @ {slo['target']:.3%}: "
            f"burn rate {br if br is not None else 'n/a'}"
            f"{'  ** BURNING **' if br is not None and br > 1 else ''}")
    lines.append("  per-group:")
    for row in doc.get("per_group", ()):
        if not row.get("up"):
            lines.append(f"    {row['source']}: DEGRADED (unreachable)")
            continue
        extras = " ".join(
            f"{k}={row[k]}" for k in sorted(row)
            if k not in ("source", "up", "e2e_p99_ms", "orders",
                         "stale", "hb_age_s", "hb_intervals",
                         "hb_sample_seq", "events_frozen",
                         "events_lag_bytes"))
        mark = ""
        if row.get("stale"):
            bits = []
            if row.get("events_frozen"):
                bits.append(f"event log frozen "
                            f"({row.get('events_lag_bytes', 0)}B "
                            f"unflushed)")
            if row.get("hb_age_s") is not None:
                bits.append(f"heartbeat {row['hb_age_s']:.1f}s old "
                            f"({row.get('hb_intervals', 0):.1f} "
                            f"intervals)")
            if row.get("hb_sample_seq") is not None:
                bits.append(f"sample_seq frozen at "
                            f"{row['hb_sample_seq']}")
            mark = f" ** STALE ({', '.join(bits) or 'frozen'}) **"
        lines.append(f"    {row['source']}: orders={row['orders']} "
                     f"e2e_p99={row['e2e_p99_ms']}ms {extras}{mark}")
    ex = doc.get("exemplars") or ()
    if ex:
        lines.append("  slowest orders (kme-torch-trace --order AID:OID):")
        for e in ex[:8]:
            lines.append(
                f"    {e.get('e2e_us', 0):>9}us aid={e.get('aid')} "
                f"oid={e.get('oid')} g={e.get('g')} off={e.get('off')} "
                f"tid=0x{int(e.get('tid', 0)):x} [{e.get('source')}]")
    return "\n".join(lines)


__all__ = [
    "SPAN_KINDS", "trace_id", "local_tid", "child_tid",
    "client_trace_id", "client_trace_ids", "route_map",
    "collect_group_spans", "stitch",
    "stitch_state_root", "discover_groups", "find_order",
    "waterfall_text", "chrome_trace_doc", "merge_latencies",
    "aggregate", "load_snapshots", "render_agg",
]
