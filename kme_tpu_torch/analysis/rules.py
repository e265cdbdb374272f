"""AST rule families for kme-torch-lint (hot-path, determinism, dtype) —
the port of `kme_tpu/analysis/rules.py`, keyed by the port's paths.

Every rule carries a stable ID (the baseline and the gate key on it)
and is scoped: hot-path rules fire only inside the pipelined submit
window (HOT_SCOPES), determinism rules only inside replay-affecting
functions (REPLAY_SCOPES and the tables merged into it), dtype rules
only under engine/ and ops/. Scopes are named per file so a refactor
that moves a function out of the hot window stops linting it — the rule
follows the architecture, not the text. Every (file, function) a table
names exists in the port (tests/test_torch_analysis.py checks it).

What changed against the JAX package's rules:

- KME-H001 is torch's host syncs: `.item()`, `.cpu()`, `.numpy()`,
  `.tolist()`, `.to("cpu")`, and `.synchronize()` (torch.cuda's,
  an Event's or a Stream's), in place of `block_until_ready`,
  `jax.device_get` and `np.asarray` on device values. A Python
  `if`/`while`/`assert` on a `torch.*` expression inside a hot scope is
  H001 too: on a CUDA tensor it reads the card.
- KME-T001 (a Python branch on a traced value) is dropped from the
  registry: eager torch has no tracer, so such a branch is legal code
  that reads the device — a host sync, which the rule above reports
  where it matters, inside the submit window. The serial parity replica
  (engine/parity.py) branches on device values on purpose, once per
  loop iteration.
- KME-D002 also names torch's RNG (`torch.rand*`, `randint`,
  `randperm`, `manual_seed`, `Generator`).
- KME-T002 / T003 cover torch's constructors (`torch.zeros/ones/empty/
  full/arange/tensor` without `dtype=`) and dtypes (`dtype=int/float`,
  `.to(int/float)`, `torch.float64` / `torch.double`) beside numpy's.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from kme_tpu_torch.analysis import Finding

# -- rule registry ----------------------------------------------------------

RULES: Dict[str, str] = {
    "KME-H001": "host sync (.item() / .cpu() / .numpy() / .tolist() / "
                ".to('cpu') / .synchronize(), or a Python branch on a "
                "torch expression) inside the pipelined submit window",
    "KME-H002": "blocking I/O (sleep, print, open, fsync, flush, "
                "subprocess) inside the pipelined submit window",
    "KME-D001": "wall clock (time.time/time_ns, datetime.now) in a "
                "replay-affecting path",
    "KME-D002": "nondeterminism source (random, np.random, torch's "
                "RNG, uuid, os.urandom, secrets) in a replay-affecting "
                "path",
    "KME-T002": "implicit dtype — tensor/array creation without dtype= "
                "(float32 or int64 by default) in engine/ or ops/",
    "KME-T003": "width-unstable dtype (dtype=int/float, astype/to(int/"
                "float), float64/double) in engine/ or ops/",
    "KME-L001": "lock-order cycle in the static acquisition graph",
    "KME-L002": "attribute mutated from multiple threads without a "
                "common lock",
    "KME-C001": "direct wall-clock/sleep call (time.time/monotonic/"
                "sleep/time_ns) in a clock-seamed sim-reachable "
                "function — go through the injected bridge/clock.py "
                "seam",
    "KME-E001": "wall clock / RNG in an event-identity path "
                "(telemetry/events.py) — event KEYS (src, seq, kind, "
                "detail) must be replay-deterministic bytes; only the "
                "advisory ts stamp may ride a clock, and only through "
                "the injected seam",
}

# -- scope tables -----------------------------------------------------------
#
# Hot scopes: the submit half of the double-buffered pipeline — between
# a batch's fetch and its device dispatch, any host sync or blocking
# I/O serializes the pipeline and shows up as measured_overlap_frac
# collapse. Collect-side functions (_collect_one, collect,
# _fetch_outputs) legitimately sync and are NOT listed.
HOT_SCOPES: Dict[str, Set[str]] = {
    "kme_tpu_torch/bridge/service.py": {"_step_pipelined", "_parse_batch"},
    # `_Staging.stage` fills the pinned ring slot and queues its H2D copy
    # inside submit: it belongs to the window. Its one wait — on the copy
    # event of the slot it is about to rewrite, issued ring-length
    # batches earlier — is the sanctioned ring wait, grandfathered in
    # LINT_BASELINE_TORCH.json with that note.
    "kme_tpu_torch/runtime/seqsession.py": {"submit", "_plan", "stage"},
    "kme_tpu_torch/native/sched.py": {"plan_batch", "apply_placement",
                                "slice_windows"},
    # the mesh planner + elastic placement decision run per batch on
    # the host between dispatches; the MIGRATION executors
    # (_migrate/_maybe_rebalance) legitimately sync the state pytree
    # and are NOT listed, like the collect-side functions above.
    # Async dispatch adds the submit-side windows: the dispatch
    # planner, the per-shard stage+submit step, and the dependency
    # patcher all sit between queue pop and device dispatch — a host
    # sync there re-serializes the per-chip streams. The collect
    # barrier (_collect_merge/_dispatch_async walls) legitimately
    # syncs and is NOT listed.
    "kme_tpu_torch/parallel/seqmesh.py": {"plan_windows", "plan_rebalance",
                                    "plan_dispatch",
                                    "_stage_and_dispatch",
                                    "_patch_shard"},
    # the front door's merge loop sits on the serving path of EVERY
    # group's consumer — a blocking call here stalls the global feed;
    # accept_frames is the binary front door itself (one C call per
    # batch — any blocking attr here re-taxes every ingress frame)
    "kme_tpu_torch/bridge/front.py": {"merge_records", "merge_streams",
                                "accept_frames"},
    # the binary produce path batches its durable write into ONE
    # flush via _flush_log_lines (deliberately un-scoped: it is the
    # sanctioned batched exit point) — per-record blocking I/O
    # reappearing inside the loop is exactly the JSON-ingress tax
    # this path exists to remove
    "kme_tpu_torch/bridge/broker.py": {"produce_frames"},
}

# Replay scopes: functions whose outputs must be bit-identical when a
# crash-resume replays the MatchIn tail — journal replay/derivation,
# checkpoint restore, and (epoch, out_seq) stamp regeneration. A wall
# clock or RNG here diverges the replay from the original run and the
# broker dedups the wrong records.
REPLAY_SCOPES: Dict[str, Set[str]] = {
    "kme_tpu_torch/telemetry/journal.py": {
        "_resume_tail", "rewind_to_offset", "oracle_events",
        "batch_events", "canonical_lines", "iter_events",
        "read_events"},
    "kme_tpu_torch/bridge/broker.py": {"_load_topic"},
    # the binary frame decoder feeds the broker's stored values (and
    # therefore the durable log + oracle replay): it must re-decode a
    # replayed buffer to bit-identical records, so no clock/RNG may
    # leak into the walk
    "kme_tpu_torch/wire.py": {"decode_frame", "decode_frames",
                        "_check_frame_header"},
    "kme_tpu_torch/bridge/service.py": {"_init_exactly_once", "_try_resume",
                                  # cross-shard transfer routing: the
                                  # MatchOut/Xfer split and the stamp
                                  # assignment must regenerate
                                  # identically on crash-replay
                                  "_produce_out", "_produce_xfer"},
    # the split IS the transfer regeneration path: a crash-replay
    # re-runs route_line over the MatchIn prefix and must emit the
    # byte-identical injected legs (same grants, same xids)
    "kme_tpu_torch/bridge/front.py": {"route_line", "split",
                                "make_internal_transfer",
                                "make_internal_create"},
    "kme_tpu_torch/runtime/checkpoint.py": {
        "load_session", "load_seq_session", "load_native",
        "load_oracle", "snapshot_extra", "oldest_retained_offset"},
    # the elastic placement decision must be RNG-free: a migration is
    # replayed as part of the batch sequence, and a random tie-break
    # would put lanes on different shards across original vs resumed
    # runs (harmless for MatchOut bytes, but it diverges the per-shard
    # telemetry and the planner's window stream — keep it deterministic)
    "kme_tpu_torch/parallel/seqmesh.py": {"plan_rebalance"},
}

# Trace-identity scopes (KME-D00x, same determinism rules): trace ids
# are REPLAY-DERIVED identity — a crash-replay must re-mint the exact
# same id for the same order, and a post-mortem stitch re-derives them
# offline. A wall clock or RNG in any of these functions breaks the
# waterfall join silently (ids stop matching across replay segments),
# so the lint holds the line the tests can't see. Merged into
# replay_fns per file by _RuleVisitor.
TRACE_SCOPES: Dict[str, Set[str]] = {
    "kme_tpu_torch/telemetry/dtrace.py": {
        "_tid_mix", "trace_id", "local_tid", "child_tid",
        "client_trace_id", "route_map", "collect_group_spans",
        "_spans_from_lat", "stitch"},
}

# Feed scopes (KME-D00x, same determinism rules): the market-data
# read path's REPLAY-PURITY surface. Book-delta derivation
# must be a pure function of the MatchOut stream — any two derivers at
# the same (group, out_seq) watermark must emit byte-identical frames,
# which is the entire failover story for the feed tier (a promoted
# deriver regenerates the dead one's frames exactly). A wall clock or
# RNG anywhere in the derivation, the frame codec, or the snapshot
# save/restore forks the frame stream silently. Merged into replay_fns
# per file by _RuleVisitor, like TRACE_SCOPES.
# X-ray scopes (KME-D00x, same determinism rules): time-travel
# materialization and live watchpoints. A watchpoint must
# be a pure function of (predicate, ledger-at-barrier): the SAME seeded
# run must produce the SAME hit set, and an offline `kme-xray eval` at
# the captured offset must re-fire — a wall clock or RNG anywhere in
# predicate parsing/evaluation or in the snapshot+replay walk forks
# live hits from their own repro commands. Merged into replay_fns per
# file by _RuleVisitor, like TRACE_SCOPES.
XRAY_SCOPES: Dict[str, Set[str]] = {
    "kme_tpu_torch/telemetry/xray.py": {
        # offset-addressed materialization: anchor choice + replay
        "oldest_materializable", "_fetch_records", "_parse_replay",
        "_engine_from_snapshot", "materialize", "resolve_trace",
        # predicate grammar + evaluation (live AND offline paths)
        "parse_watch", "_cmp", "measure", "eval_predicate",
        "measure_engine", "eval_engine", "book_summary",
        # barrier-side observation (everything but the capture write)
        "seed", "observe_lines", "observe_events", "_repro_line",
        # bisection state projection + comparison
        "_journal_batches", "_batch_end_off", "_canon",
        "shadow_canon", "engine_canon", "state_diff",
        # cluster-cut accounting
        "_open_margin"},
}

FEED_SCOPES: Dict[str, Set[str]] = {
    "kme_tpu_torch/feed/frames.py": {
        "_envelope", "encode_delta", "encode_tob", "encode_depth",
        "encode_snap_begin", "encode_snap_end", "encode_resync",
        "_check_feed_header", "decode_feed", "decode_feed_frames",
        "feed_frame_length"},
    "kme_tpu_torch/feed/derive.py": {
        # BookState + canonical comparators
        "set_level", "get_level", "tob", "depth", "sids",
        "canonical_books", "books_from_oracle",
        # FeedDeriver: emission + mutation + snapshot state
        "_next_seq", "_frame", "_emit_delta", "_emit_tob",
        "_emit_depth", "_level_add", "_drop_resting", "_apply_out",
        "on_record", "on_line", "state", "from_state",
        # BookBuilder: the subscriber-side replay of the frame stream
        "_seq_ok", "_apply_image", "apply", "apply_buffer"},
    # the durable snapshot payload and the wire handover must restore /
    # serve bit-identically (file naming is offset-based, never
    # clock-based; frame seqs come from the deriver, never minted here)
    "kme_tpu_torch/feed/snapshot.py": {
        "feed_snapshot_path", "_state_digest", "_load_one",
        "snapshot_frames"},
}

# Clock-seam scopes (KME-C001): functions the deterministic
# whole-cluster simulator (kme_tpu_torch/sim/) reaches while it owns time.
# Each listed function received an injectable clock (bridge/clock.py)
# and must keep every wait/stamp/interval read on that seam: one direct
# ``time.sleep`` in a retry loop turns a reproducible seed into a
# wall-clock race, and a direct ``time.time_ns`` admission stamp forks
# the virtual-time latency attribution. ``perf_counter`` is deliberately
# NOT flagged — host profiling durations are observability, not
# behavior, and stay on the real clock by design (PROFILER_SCOPES
# below documents the same boundary for the profiling plane).
# ``run`` (service) is deliberately NOT listed: its serve.stuck /
# stall-drill branches block the real process on purpose, and the sim
# drives ``step()`` directly.
CLOCK_SCOPES: Dict[str, Set[str]] = {
    "kme_tpu_torch/bridge/service.py": {
        "step", "_step_pipelined", "_process_batch", "_produce_retry",
        "_publish_batch", "_write_heartbeat"},
    "kme_tpu_torch/bridge/broker.py": {"produce", "fetch"},
    "kme_tpu_torch/bridge/replica.py": {"fetch", "run", "_write_heartbeat",
                                  "_promote"},
    "kme_tpu_torch/bridge/tcp.py": {"_ats_for"},
}

# Event-identity scopes (KME-E001): the control-plane
# flight recorder's replay-determinism surface. A merged timeline is
# digested byte-for-byte (the sim's seventh verdict) and deduped on
# (src, seq) — so everything that BUILDS event identity (make/encode/
# order/dedup/digest) and everything that assigns the durable seq
# cursor (emit + the open/rescan paths) must be clock- and RNG-free.
# The one sanctioned clock touch is the ADVISORY ts stamp, and it must
# flow through the injected ``clock`` seam; the default-clock fallback
# in ``EventLog.__init__`` is the single grandfathered finding (the
# seam has to bottom out somewhere), held in LINT_BASELINE_TORCH.json so any
# NEW wall read or RNG in these functions still gates. Unlike the
# D-family this rule also flags bare REFERENCES (``x = time.time``):
# smuggling the function object past the seam is the failure mode the
# injectable-clock design invites.
EVENTS_SCOPES: Dict[str, Set[str]] = {
    "kme_tpu_torch/telemetry/events.py": {
        "make_event", "event_line", "order_key", "sort_events",
        "dedup_events", "merge_events", "timeline_digest",
        "emit", "__init__", "_open_live", "_seed_seq_from_rotated"},
}

# Profiler scopes: the continuous-profiling plane is
# DELIBERATELY outside every table above, and this entry documents the
# boundary so the exemption is a reviewed decision rather than an
# accident of omission.
#
#  - telemetry/tsdb.py appends, fsyncs, and rotates ON PURPOSE — it is
#    the durable history store, called only from the 1 Hz heartbeat
#    thread (serve/standby/feed) or a one-shot CLI exit path, never
#    from the submit half of the pipeline. Listing it in HOT_SCOPES
#    would flag its whole reason to exist.
#  - telemetry/profiler.py reads wall clocks and sleeps ON PURPOSE —
#    the sampler thread's time.sleep cadence and the capture files'
#    timestamps are the measurement, not state. Nothing here feeds
#    replay: TSDB samples are observability output, dedup'd by
#    sample_seq, and never re-derived on crash-resume, so REPLAY
#    determinism rules don't apply.
#
# The sanctioned coupling points back into scoped code are narrow and
# already covered: service._publish_batch / _write_heartbeat run on
# the telemetry thread (not HOT), and the TSDB append in the serve
# loop is fenced behind `self.tsdb is not None`. If a profiler call
# ever migrates into a HOT_SCOPES function, the existing hot-scope
# lint catches it at the call site — no profiler-side rule needed.
PROFILER_SCOPES: Dict[str, Set[str]] = {
    "kme_tpu_torch/telemetry/tsdb.py": set(),
    "kme_tpu_torch/telemetry/profiler.py": set(),
}

# Device-code scopes: whole directories — the engines and the ops whose
# tensors live on the card (the dtype rules apply there).
TRACED_DIRS = ("kme_tpu_torch/engine/", "kme_tpu_torch/ops/")

# methods that read a CUDA tensor back to the host or wait for the card
_HOST_SYNC_ATTRS = {"item", "cpu", "numpy", "tolist", "synchronize"}
_BLOCKING_CALLS = {
    ("time", "sleep"), ("os", "fsync"), ("os", "fdatasync"),
    ("subprocess", "run"), ("subprocess", "check_output"),
    ("subprocess", "Popen"), ("subprocess", "call"),
}
_BLOCKING_METHOD_ATTRS = {"write", "flush", "fsync", "sendall",
                          "recv", "readline"}
_WALLCLOCK = {("time", "time"), ("time", "time_ns"),
              ("time", "clock_gettime"), ("datetime", "now"),
              ("datetime", "utcnow"), ("datetime", "today")}
# the clock-seam family adds the interval/wait primitives the replay
# rule doesn't care about, and tolerates the repo's import aliases
# (``import time as _t`` / ``as _time``) — an alias must not launder a
# wall read past the seam
_CLOCK_HEADS = {"time", "_time", "_t"}
_CLOCK_TAILS = {"time", "time_ns", "clock_gettime", "monotonic",
                "monotonic_ns", "sleep"}
_RANDOM_MODULES = {"random", "secrets", "uuid"}
# torch's RNG entry points (torch.X, torch.cuda.X)
_TORCH_RANDOM = {"rand", "rand_like", "randn", "randn_like", "randint",
                 "randint_like", "randperm", "manual_seed",
                 "manual_seed_all", "seed", "seed_all", "Generator",
                 "bernoulli", "multinomial", "normal", "poisson"}
_IMPLICIT_CTORS = {"zeros", "ones", "empty", "full", "arange",
                   "linspace", "array", "asarray", "fromiter", "tensor"}
_CTOR_HEADS = ("np", "numpy", "torch")


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _RuleVisitor(ast.NodeVisitor):
    def __init__(self, relpath: str, src_lines: List[str]) -> None:
        self.relpath = relpath
        self.lines = src_lines
        self.findings: List[Finding] = []
        self._scope: List[str] = []
        self.hot_fns = HOT_SCOPES.get(relpath, set())
        self.replay_fns = (REPLAY_SCOPES.get(relpath, set())
                           | TRACE_SCOPES.get(relpath, set())
                           | FEED_SCOPES.get(relpath, set())
                           | XRAY_SCOPES.get(relpath, set()))
        self.clock_fns = CLOCK_SCOPES.get(relpath, set())
        self.events_fns = EVENTS_SCOPES.get(relpath, set())
        self.traced = relpath.startswith(TRACED_DIRS)

    # -- bookkeeping ----------------------------------------------------

    def _scope_name(self) -> str:
        return ".".join(self._scope) if self._scope else "<module>"

    def _in(self, table: Set[str]) -> bool:
        return any(name in table for name in self._scope)

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        snippet = (self.lines[line - 1].strip()
                   if 0 < line <= len(self.lines) else "")
        self.findings.append(Finding(
            rule=rule, path=self.relpath, line=line,
            col=getattr(node, "col_offset", 0),
            scope=self._scope_name(), message=message,
            snippet=snippet))

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    def _visit_fn(self, node) -> None:
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    # -- H/D families (call-shaped) -------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func) or ""
        head, _, tail = dotted.partition(".")
        if self._in(self.hot_fns):
            self._check_hot_call(node, dotted, head, tail)
        if self._in(self.replay_fns):
            self._check_replay_call(node, dotted, head, tail)
        if self._in(self.clock_fns):
            self._check_clock_call(node, dotted, head, tail)
        if self._in(self.events_fns):
            self._check_events_call(node, dotted, head, tail)
        if self.traced:
            self._visit_traced_call(node)
        self.generic_visit(node)

    def _check_hot_call(self, node, dotted, head, tail) -> None:
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _HOST_SYNC_ATTRS:
            self._emit("KME-H001", node,
                       f"'{node.func.attr}()' forces a host/device "
                       f"sync inside the submit window")
            return
        if isinstance(node.func, ast.Attribute) and node.func.attr == "to" \
                and self._to_cpu(node):
            self._emit("KME-H001", node,
                       "'.to(\"cpu\")' copies to the host inside the "
                       "submit window (a CUDA tensor blocks here)")
            return
        if (head, tail) in _BLOCKING_CALLS or head == "subprocess":
            self._emit("KME-H002", node,
                       f"blocking call '{dotted}()' inside the submit "
                       f"window")
            return
        if dotted in ("print", "open", "input"):
            self._emit("KME-H002", node,
                       f"blocking I/O '{dotted}()' inside the submit "
                       f"window")
            return
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _BLOCKING_METHOD_ATTRS:
            self._emit("KME-H002", node,
                       f"blocking I/O method '.{node.func.attr}()' "
                       f"inside the submit window")

    @staticmethod
    def _to_cpu(node: ast.Call) -> bool:
        """`.to("cpu")` / `.to(device="cpu")` / `.to(torch.device("cpu"))`."""
        vals = list(node.args[:1]) + [kw.value for kw in node.keywords
                                      if kw.arg == "device"]
        for v in vals:
            for sub in ast.walk(v):
                if isinstance(sub, ast.Constant) and sub.value == "cpu":
                    return True
        return False

    @staticmethod
    def _torch_random(dotted: str) -> bool:
        parts = dotted.split(".")
        return parts[0] == "torch" and len(parts) >= 2 and (
            parts[-1] in _TORCH_RANDOM
            and (len(parts) == 2 or parts[1] in ("cuda", "random")))

    def _check_replay_call(self, node, dotted, head, tail) -> None:
        if (head, tail) in _WALLCLOCK or dotted in (
                "datetime.datetime.now", "datetime.datetime.utcnow"):
            self._emit("KME-D001", node,
                       f"wall clock '{dotted}()' in a replay-affecting "
                       f"path (replay would diverge from the original "
                       f"run)")
            return
        if head in _RANDOM_MODULES or dotted.startswith(
                ("np.random", "numpy.random", "os.urandom")) \
                or self._torch_random(dotted):
            self._emit("KME-D002", node,
                       f"nondeterminism source '{dotted}()' in a "
                       f"replay-affecting path")

    def _events_offender(self, dotted: str) -> Optional[str]:
        """The KME-E001 predicate, shared by the call and the bare-
        reference checks: a wall-clock or RNG dotted name."""
        head, _, tail = dotted.partition(".")
        if head in _CLOCK_HEADS and tail in _CLOCK_TAILS:
            return "wall clock"
        if dotted in ("datetime.datetime.now", "datetime.now",
                      "datetime.datetime.utcnow", "datetime.utcnow"):
            return "wall clock"
        if head in _RANDOM_MODULES or dotted.startswith(
                ("np.random", "numpy.random")) or dotted == "os.urandom" \
                or self._torch_random(dotted):
            return "nondeterminism source"
        return None

    def _check_events_call(self, node, dotted, head, tail) -> None:
        kind = self._events_offender(dotted)
        if kind:
            self._emit("KME-E001", node,
                       f"{kind} '{dotted}()' in an event-identity "
                       f"path — event keys must replay "
                       f"byte-identically; stamp advisory ts through "
                       f"the injected clock seam")

    def _check_clock_call(self, node, dotted, head, tail) -> None:
        if head in _CLOCK_HEADS and tail in _CLOCK_TAILS:
            self._emit("KME-C001", node,
                       f"direct '{dotted}()' in a clock-seamed "
                       f"function — the simulator owns time here; use "
                       f"the injected clock (bridge/clock.py)")
        elif dotted in ("datetime.datetime.now",
                        "datetime.datetime.utcnow"):
            self._emit("KME-C001", node,
                       f"direct '{dotted}()' in a clock-seamed "
                       f"function — use the injected clock "
                       f"(bridge/clock.py)")

    # -- branches on torch expressions (hot scopes only) ----------------

    @staticmethod
    def _torch_test(test: ast.AST) -> Optional[str]:
        """A torch.-built expression used as a Python bool — on a CUDA
        tensor that reads the card. Returns the offending dotted call."""
        for sub in ast.walk(test):
            if isinstance(sub, ast.Call):
                dotted = _dotted(sub.func) or ""
                if dotted.split(".", 1)[0] == "torch":
                    return dotted
        return None

    def _check_branch(self, node, test) -> None:
        if not self._in(self.hot_fns):
            return
        dotted = self._torch_test(test)
        if dotted:
            kind = type(node).__name__.lower()
            self._emit("KME-H001", node,
                       f"Python-level {kind} on torch expression "
                       f"'{dotted}(...)' inside the submit window — a "
                       f"CUDA value blocks here; keep it on the card "
                       f"(torch.where) or decide on host data")

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)

    # -- T family (engine/ops only) -------------------------------------

    def _has_float_literal(self, node: ast.Call) -> bool:
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(a):
                if isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, float):
                    return True
        return False

    def _check_dtype_value(self, node: ast.AST, where: ast.AST) -> None:
        """dtype=int / dtype=float / dtype=np.float64 etc."""
        if isinstance(node, ast.Name) and node.id in ("int", "float",
                                                      "bool"):
            if node.id != "bool":
                self._emit("KME-T003", where,
                           f"width-unstable dtype '{node.id}' (int64/"
                           f"float64 under x64, int32 on some hosts) — "
                           f"name the width explicitly")
            return
        dotted = _dotted(node) or ""
        if dotted.endswith(("float64", "double", "intp", "int_",
                            "longlong")):
            self._emit("KME-T003", where,
                       f"'{dotted}' in device code — engine tensors are "
                       f"int32 (int64 only for money/oid paths, which "
                       f"spell torch.int64 via the _I64 alias)")

    @staticmethod
    def _is_fresh_numeric(node: ast.AST) -> bool:
        """True when the expression builds fresh numeric data whose
        width the ctor's default dtype decides: int/float literals
        (not bool), unary minus on them, and list/tuple nests of
        them."""
        if isinstance(node, ast.Constant):
            return type(node.value) in (int, float)
        if isinstance(node, ast.UnaryOp) \
                and isinstance(node.op, (ast.USub, ast.UAdd)):
            return _RuleVisitor._is_fresh_numeric(node.operand)
        if isinstance(node, (ast.List, ast.Tuple)):
            return bool(node.elts) and all(
                _RuleVisitor._is_fresh_numeric(e) for e in node.elts)
        return False

    def _visit_traced_call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func) or ""
        head, _, tail = dotted.partition(".")
        # T002: np/torch constructors with no dtype= — the result width
        # is the library's default (float32/float64, int64)
        if head in _CTOR_HEADS and tail in _IMPLICIT_CTORS:
            has_dtype = any(kw.arg == "dtype" for kw in node.keywords)
            # numpy's dtype rides positionally for most ctors: 2nd arg of
            # zeros/ones/empty/fromiter/array/asarray, 3rd of full(shape,
            # fill, dt) (torch's dtype is keyword-only)
            if not has_dtype and head != "torch" and tail in (
                    "zeros", "ones", "empty", "fromiter", "array",
                    "asarray") and len(node.args) >= 2:
                has_dtype = True
            if not has_dtype and head != "torch" and tail == "full" \
                    and len(node.args) >= 3:
                has_dtype = True
            # array/asarray/tensor of existing data is dtype-PRESERVING —
            # only fresh data (int/float literals, possibly nested in
            # lists/tuples) picks up the default width
            if not has_dtype and tail in ("array", "asarray", "tensor"):
                if not (node.args
                        and self._is_fresh_numeric(node.args[0])):
                    has_dtype = True
            if not has_dtype:
                self._emit("KME-T002", node,
                           f"'{dotted}()' without dtype= — the width "
                           f"is the library's default (float32/float64, "
                           f"int64); pin it")
        # T003: explicit width-unstable dtypes
        for kw in node.keywords:
            if kw.arg == "dtype":
                self._check_dtype_value(kw.value, node)
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("astype", "to") and node.args:
            self._check_dtype_value(node.args[0], node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.traced:
            dotted = _dotted(node) or ""
            if dotted in ("torch.float64", "torch.double", "np.float64",
                          "numpy.float64", "np.double"):
                self._emit("KME-T003", node,
                           f"'{dotted}' reference in device code "
                           f"(implicit float64 surface)")
        if self._in(self.events_fns):
            # KME-E001 flags bare references too: `clock or time.time`
            # hands the wall clock past the injected seam without a
            # single call-shaped node
            dotted = _dotted(node) or ""
            kind = self._events_offender(dotted)
            if kind:
                self._emit("KME-E001", node,
                           f"{kind} '{dotted}' referenced in an "
                           f"event-identity path — inject it through "
                           f"the clock seam instead")
        self.generic_visit(node)


def analyze_file(relpath: str, source: str) -> List[Finding]:
    """Run the H/D/C/E/T rule families over one file. L-family findings
    come from lockgraph.analyze_modules (cross-file)."""
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as e:
        return [Finding(rule="KME-E000", path=relpath,
                        line=e.lineno or 1, col=e.offset or 0,
                        scope="<module>",
                        message=f"syntax error: {e.msg}", snippet="")]
    v = _RuleVisitor(relpath, source.splitlines())
    v.visit(tree)
    # one finding per (rule, line): the dtype checks can fire twice on
    # one expression (kw value + attribute walk)
    seen, out = set(), []
    for f in v.findings:
        key = (f.rule, f.line)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
