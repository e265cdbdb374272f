"""Process-wide, seed-deterministic fault-injection registry (kme-chaos).

The reference inherits its fault story from Kafka Streams (partition
reassignment + changelog restore); our replacement is the
kme-supervise -> checkpoint/resume -> journal/audit stack. This module
is the thing that ATTACKS that stack on purpose: named injection points
threaded through the broker/TCP transport, checkpoint save, the journal
writer and the serve loop fire faults according to a declarative,
seeded schedule, so a chaos run (bridge/chaos.py) is exactly
reproducible from its spec string.

Activation: set ``KME_FAULTS`` to a spec, e.g.

    KME_FAULTS="seed=42;broker.fetch:n=2;ckpt.torn:n=1:after=1;serve.kill:at=180"

Spec grammar — ';'-separated clauses. ``seed=N`` seeds every rule's RNG
(default 0). Every other clause is ``<point>[:key=value]...`` with

    p=F      fire probability per eligible hit (default 1.0)
    n=K      max fires for this rule (default 1; 0 = unlimited)
    after=K  skip the first K eligible hits (per process)
    at=N     offset gate: fire only once the call-site offset >= N
             (kill/stall points pass the service input offset)
    frac=F   for *.torn points: keep this fraction of the file
             (default 0.5)
    ms=K     magnitude in milliseconds for the net.*/clock.* points
             (partition window, added delivery delay, wall skew;
             default 50)

Known injection points (the call sites document themselves; grep for
``faults.``):

    broker.produce   InProcessBroker.produce raises BrokerError
    broker.fetch     InProcessBroker.fetch raises BrokerError
    tcp.partial      TCP handler writes half a reply, then drops the
                     connection (client sees a poisoned stream)
    tcp.disconnect   TCP handler drops the connection without replying
    ckpt.torn        truncate the just-renamed snapshot file
    ckpt.bitflip     flip one deterministic bit in the snapshot file
    journal.torn     write half a journal record, fsync, SIGKILL self
                     (a crash mid-journal-append)
    serve.kill       SIGKILL the serve process at an input offset
    serve.stuck      freeze the serve loop (tick stops, heartbeat
                     thread lives) at an input offset
    lease.steal      split-brain drill: another incarnation steals the
                     leader lease (next epoch + broker fence) right
                     before a checkpoint — the current leader must
                     detect it and die fenced, never write
    standby.lag      stall the hot-standby follower mid-tail (the
                     promotion path must absorb the catch-up)
    net.partition    sim transport: sever the front->group link for
                     `ms` virtual milliseconds (deliveries queue FIFO
                     and flush on heal — never drop)
    net.delay        sim transport: add `ms` virtual milliseconds to
                     one delivery (the whole link shifts behind it;
                     per-link FIFO order is preserved, like TCP)
    net.reorder      sim transport: re-send an EARLIER stamped record
                     after newer ones (an out-of-order duplicate
                     produce — the broker's idempotence watermark must
                     swallow it)
    clock.skew       sim: step one actor's wall clock by `ms` (stamps
                     shift; monotonic intervals don't, like NTP)

Cross-process accounting: under a supervisor, a restarted child re-reads
the same KME_FAULTS — an ``n``-limited rule must not refire every
incarnation. Set ``KME_FAULTS_STATE`` to a directory and each rule
persists its fire count there (one small file per rule), making ``n``
global across restarts. ``bridge/chaos.py`` always sets it.

No package imports here (call sites raise their own exception types);
when KME_FAULTS is unset every ``should()`` is a cheap None check.
"""

from __future__ import annotations

import os
import random
import signal
import sys
import threading
from typing import List, Optional

ENV_SPEC = "KME_FAULTS"
ENV_STATE = "KME_FAULTS_STATE"

_POINTS = ("broker.produce", "broker.fetch", "tcp.partial",
           "tcp.disconnect", "ckpt.torn", "ckpt.bitflip", "journal.torn",
           "serve.kill", "serve.stuck", "lease.steal", "standby.lag",
           "net.partition", "net.delay", "net.reorder", "clock.skew")


class FaultSpecError(ValueError):
    """Malformed KME_FAULTS spec (surfaced loudly, never ignored)."""


class Rule:
    __slots__ = ("idx", "point", "p", "n", "after", "at", "frac", "ms",
                 "hits", "fires", "rng")

    def __init__(self, idx: int, point: str, seed: int, p: float = 1.0,
                 n: int = 1, after: int = 0, at: Optional[int] = None,
                 frac: float = 0.5, ms: int = 50) -> None:
        self.idx = idx
        self.point = point
        self.p = p
        self.n = n
        self.after = after
        self.at = at
        self.frac = frac
        self.ms = ms
        self.hits = 0           # eligible call-site visits (per process)
        self.fires = 0          # fires (per process)
        # one independent deterministic stream per rule: stable across
        # restarts and insensitive to other rules' draw order
        self.rng = random.Random((seed, idx, point).__repr__())

    def describe(self) -> str:
        bits = [self.point]
        if self.p < 1.0:
            bits.append(f"p={self.p}")
        bits.append(f"n={self.n}")
        if self.after:
            bits.append(f"after={self.after}")
        if self.at is not None:
            bits.append(f"at={self.at}")
        if self.ms != 50:
            bits.append(f"ms={self.ms}")
        return ":".join(bits)


class FaultPlan:
    """A parsed spec + its per-rule state (see module docstring)."""

    def __init__(self, spec: str, state_dir: Optional[str] = None) -> None:
        self.spec = spec
        self.state_dir = state_dir
        self.seed = 0
        self.rules: List[Rule] = []
        self._lock = threading.Lock()
        clauses = [c.strip() for c in spec.split(";") if c.strip()]
        pending = []
        for clause in clauses:
            if clause.startswith("seed="):
                self.seed = int(clause[5:])
                continue
            fields = clause.split(":")
            point, kv = fields[0], fields[1:]
            if point not in _POINTS:
                raise FaultSpecError(
                    f"unknown fault point {point!r} (known: "
                    f"{', '.join(_POINTS)})")
            kwargs = {}
            for f in kv:
                k, sep, v = f.partition("=")
                if not sep:
                    raise FaultSpecError(f"bad fault field {f!r} in "
                                         f"{clause!r} (want key=value)")
                if k in ("n", "after", "at", "ms"):
                    kwargs[k] = int(v)
                elif k in ("p", "frac"):
                    kwargs[k] = float(v)
                else:
                    raise FaultSpecError(
                        f"unknown fault field {k!r} in {clause!r}")
            pending.append((point, kwargs))
        for idx, (point, kwargs) in enumerate(pending):
            self.rules.append(Rule(idx, point, self.seed, **kwargs))
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)

    # -- cross-process fire accounting ---------------------------------

    def _state_path(self, rule: Rule) -> str:
        return os.path.join(self.state_dir,
                            f"rule{rule.idx}.{rule.point}.fired")

    def _persisted_fires(self, rule: Rule) -> int:
        if not self.state_dir:
            return 0
        try:
            with open(self._state_path(rule)) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _record_fire(self, rule: Rule, total: int) -> None:
        if not self.state_dir:
            return
        tmp = self._state_path(rule) + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(total))
        os.replace(tmp, self._state_path(rule))

    # -- the decision --------------------------------------------------

    def fire(self, point: str, offset: Optional[int] = None
             ) -> Optional[Rule]:
        """Decide whether `point` fires at this call site. Returns the
        rule that fired (for torn/bitflip parameters) or None."""
        with self._lock:
            for rule in self.rules:
                if rule.point != point:
                    continue
                if rule.at is not None and (offset is None
                                            or offset < rule.at):
                    continue
                rule.hits += 1
                if rule.hits <= rule.after:
                    continue
                # persisted count wins under a state dir (cross-process
                # n); the in-process count otherwise
                total = (self._persisted_fires(rule) if self.state_dir
                         else rule.fires)
                if rule.n > 0 and total >= rule.n:
                    continue
                if rule.p < 1.0 and rule.rng.random() >= rule.p:
                    continue
                rule.fires += 1
                if self.state_dir:
                    self._record_fire(rule, total + 1)
                print(f"kme-faults: injected {point} "
                      f"(rule {rule.idx}, fire {total + 1})",
                      file=sys.stderr)
                return rule
        return None

    def fired_total(self) -> int:
        """Fires observed by THIS process (telemetry gauge)."""
        with self._lock:
            return sum(r.fires for r in self.rules)


# ---------------------------------------------------------------------------
# module-level plan (lazily loaded from the environment)

_plan: Optional[FaultPlan] = None
_loaded = False
_load_lock = threading.Lock()


def _get_plan() -> Optional[FaultPlan]:
    global _plan, _loaded
    if not _loaded:
        with _load_lock:
            if not _loaded:
                spec = os.environ.get(ENV_SPEC)
                if spec:
                    _plan = FaultPlan(spec, os.environ.get(ENV_STATE))
                _loaded = True
    return _plan


def configure(spec: Optional[str],
              state_dir: Optional[str] = None) -> Optional[FaultPlan]:
    """Install a plan explicitly (tests / embedding); None clears it."""
    global _plan, _loaded
    with _load_lock:
        _plan = FaultPlan(spec, state_dir) if spec else None
        _loaded = True
    return _plan


def clear() -> None:
    """Drop the installed plan and return to lazy env loading."""
    global _plan, _loaded
    with _load_lock:
        _plan = None
        _loaded = False


def active() -> bool:
    return _get_plan() is not None


def should(point: str, offset: Optional[int] = None) -> bool:
    """True iff `point` fires now (counts the fire)."""
    plan = _get_plan()
    return plan is not None and plan.fire(point, offset) is not None


def fire(point: str, offset: Optional[int] = None) -> Optional[Rule]:
    """Like ``should`` but returns the fired Rule, so parameterized
    call sites (the sim transport's ``ms`` windows, ``frac`` damage)
    can read the rule's knobs."""
    plan = _get_plan()
    return plan.fire(point, offset) if plan is not None else None


def points() -> tuple:
    """The known injection-point names (docs / schedule generators)."""
    return _POINTS


def fired_total() -> int:
    plan = _get_plan()
    return plan.fired_total() if plan is not None else 0


# -- call-site helpers ------------------------------------------------------


def damage_file(point: str, path: str,
                offset: Optional[int] = None) -> bool:
    """Post-write corruption: `*.torn` truncates `path` to the rule's
    `frac`; `*.bitflip` flips one deterministic bit. Returns True when
    damage was done (call sites never need to branch on it)."""
    plan = _get_plan()
    rule = plan.fire(point, offset) if plan is not None else None
    if rule is None:
        return False
    size = os.path.getsize(path)
    if size <= 0:
        return False
    if point.endswith(".torn"):
        with open(path, "r+b") as f:
            f.truncate(max(1, int(size * rule.frac)))
    else:  # bitflip
        pos = rule.rng.randrange(size)
        bit = rule.rng.randrange(8)
        with open(path, "r+b") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ (1 << bit)]))
    return True


def kill_now(point: str, offset: Optional[int] = None) -> None:
    """SIGKILL this process if `point` fires — the no-cleanup crash
    (atexit, finally blocks and buffered writes all die with it)."""
    if should(point, offset):
        os.kill(os.getpid(), signal.SIGKILL)
