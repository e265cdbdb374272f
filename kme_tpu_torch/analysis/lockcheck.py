"""Runtime lock-order recorder (``KME_LOCKCHECK=1``) — the port of
`kme_tpu/analysis/lockcheck.py`.

The static lock graph (lockgraph.py) over-approximates: it can't see
locks passed across modules or orders that only materialize under real
scheduling. This module validates the same discipline dynamically.
When installed (via ``kme_tpu_torch/__init__`` on ``KME_LOCKCHECK=1``),
it replaces ``threading.Lock``/``threading.RLock`` with factories that
return tracking proxies. Each proxy is named by its creation site
(``file.py:line``); a thread-local stack records what each thread
holds, and every acquisition with locks already held contributes
(held -> acquired) edges to a global order graph. An **inversion** —
both (A, B) and (B, A) observed, A != B — is a potential deadlock: two
threads can each take their first lock and block on the other's.

One recorder per process: a process that imports both packages (the
tests do) under ``KME_LOCKCHECK=1`` has the JAX package's recorder in
place first, and ``install()`` leaves it there instead of wrapping its
factories again — that recorder then tracks the port's locks too, and
its session gate checks them. ``install(over=True)`` puts this recorder
in front anyway (its locks come from ``_thread`` directly, so nothing is
tracked twice) and ``uninstall()`` gives the other one back.

Proxies intentionally do NOT expose ``_release_save`` /
``_acquire_restore`` / ``_is_owned``: ``threading.Condition`` probes
for those and, finding none, falls back to plain ``acquire``/
``release`` on the proxy — which we track. ``wait()`` therefore
correctly pops the lock from the held stack while waiting.

Zero overhead when not installed; tracking is a dict update per
contested acquisition when it is. Never enable in production.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_real_lock = _thread.allocate_lock        # pre-patch factory
_state_lock = _thread.allocate_lock()     # guards the tables below
_edges: Dict[Tuple[str, str], Tuple[str, str]] = {}   # (a,b) -> stacks
_sites: Dict[str, int] = {}               # creation site -> count
_installed = False
_orig_lock = None
_orig_rlock = None
_tls = threading.local()


def _held() -> List[str]:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def _creation_site() -> str:
    f = sys._getframe(2)
    # walk out of this module and the threading module
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.endswith(("lockcheck.py", "threading.py")):
            break
        f = f.f_back
    if f is None:
        return "<unknown>"
    rel = os.path.basename(os.path.dirname(f.f_code.co_filename))
    name = os.path.basename(f.f_code.co_filename)
    return f"{rel}/{name}:{f.f_lineno}"


class _TrackedLock:
    """Wraps a raw lock; records acquisition order by creation site."""

    __slots__ = ("_lk", "_name", "_reentrant", "_owner", "_depth")

    def __init__(self, reentrant: bool = False,
                 name: Optional[str] = None) -> None:
        self._lk = _real_lock()
        self._reentrant = reentrant
        self._owner: Optional[int] = None
        self._depth = 0
        if name is None:
            site = _creation_site()
            with _state_lock:
                n = _sites.get(site, 0)
                _sites[site] = n + 1
            name = site if n == 0 else f"{site}#{n}"
        self._name = name

    # -- the tracked core ----------------------------------------------

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        me = _thread.get_ident()
        if self._reentrant and self._owner == me:
            self._depth += 1
            return True
        if timeout == -1:
            got = self._lk.acquire(blocking)
        else:
            got = self._lk.acquire(blocking, timeout)
        if got:
            self._owner = me
            self._depth = 1
            stack = _held()
            if stack:
                snap = " -> ".join(stack + [self._name])
                with _state_lock:
                    for h in stack:
                        if h != self._name:
                            _edges.setdefault(
                                (h, self._name),
                                (snap, threading.current_thread().name))
            stack.append(self._name)
        return got

    def release(self) -> None:
        me = _thread.get_ident()
        if self._reentrant:
            if self._owner != me:
                raise RuntimeError(
                    "cannot release un-acquired lock")
            self._depth -= 1
            if self._depth:
                return
        self._owner = None
        stack = _held()
        if self._name in stack:
            # remove the innermost occurrence
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == self._name:
                    del stack[i]
                    break
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def _is_owned(self) -> bool:
        # threading.Condition probes for this by name. Without it, the
        # fallback does acquire(False)/release — which REENTERS a
        # reentrant proxy the caller already owns and concludes
        # not-owned, making Condition.wait() raise spuriously.
        # (_release_save/_acquire_restore stay intentionally absent so
        # Condition falls back to plain acquire/release, which we
        # track.)
        if self._reentrant:
            return self._owner == _thread.get_ident()
        return self._lk.locked()

    def __repr__(self) -> str:
        kind = "RLock" if self._reentrant else "Lock"
        return f"<Tracked{kind} {self._name}>"


def _make_lock():
    return _TrackedLock(reentrant=False)


def _make_rlock():
    return _TrackedLock(reentrant=True)


def foreign_recorder() -> bool:
    """True when another package's recorder (the JAX package's) has
    replaced ``threading.Lock``."""
    mod = getattr(threading.Lock, "__module__", None) or ""
    return mod.endswith("analysis.lockcheck") and mod != __name__


def install(over: bool = False) -> None:
    """Patch ``threading.Lock``/``RLock``. Locks created BEFORE this
    runs are untracked, so call it before importing modules that
    allocate locks at import or construction time. With another
    recorder already in place this is a no-op unless `over`."""
    global _installed, _orig_lock, _orig_rlock
    if _installed or (foreign_recorder() and not over):
        return
    _orig_lock = threading.Lock
    _orig_rlock = threading.RLock
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    _installed = True
    import atexit
    atexit.register(_atexit_report)


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Lock = _orig_lock
    threading.RLock = _orig_rlock
    _installed = False


def enabled() -> bool:
    return _installed


def reset() -> None:
    with _state_lock:
        _edges.clear()


def edges() -> Set[Tuple[str, str]]:
    with _state_lock:
        return set(_edges)


def inversions() -> List[Tuple[str, str, str, str]]:
    """(lock_a, lock_b, witness_ab, witness_ba) for every pair
    observed in both orders."""
    with _state_lock:
        snap = dict(_edges)
    out = []
    for (a, b), (wit_ab, _) in snap.items():
        if a < b and (b, a) in snap:
            out.append((a, b, wit_ab, snap[(b, a)][0]))
    return out


def report() -> str:
    inv = inversions()
    lines = [f"lockcheck: {len(edges())} distinct acquisition edges, "
             f"{len(inv)} inversion(s)"]
    for a, b, wab, wba in inv:
        lines.append(f"  INVERSION between {a} and {b}")
        lines.append(f"    order 1: {wab}")
        lines.append(f"    order 2: {wba}")
    return "\n".join(lines)


def assert_clean() -> None:
    inv = inversions()
    if inv:
        raise AssertionError("lock-order inversions observed:\n"
                             + report())


def _atexit_report() -> None:
    if inversions():
        print(report(), file=sys.stderr)
