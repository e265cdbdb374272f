"""Deterministic split/merge autoscaling policy.

The port of `kme_tpu/bridge/autoscale.py`: the same pure state machine,
so one gauge trace gives the same decisions, `autoscale.json` and
`autoscale.trace.jsonl` in either package. It touches no device.

The SEDA lesson (Welsh et al., PAPERS.md) applied to topology instead
of admission: the `OverloadController` sheds load WITHIN a group; this
controller decides when the group count itself should change. It is a
pure state machine in the same mold — no wall clock, no RNG, no I/O —
consuming exactly the signals the serving side already exports:

- per-group input lag (the `group{k}_lag` heartbeat gauges),
- per-group overload state codes (`overload_state`: 0 normal,
  1 shedding, 2 draining — bridge/broker.py OverloadController),

and deriving `shard_imbalance` (max/mean lag) from them. Decisions are
doubling/halving proposals (N→2N split, N→N/2 merge) because the
rendezvous assignment moves the minimal key fraction for any target,
and a power-of-two ladder keeps repeated decisions composable.

Hysteresis is explicit and threefold, so the policy cannot flap:
a split needs `dwell` CONSECUTIVE hot ticks (any group's lag at or
above `high_lag`, or any group shedding/draining); a merge needs
`dwell` consecutive cold ticks (EVERY group below `low_lag`, nobody
overloaded — and low_lag < high_lag is enforced, the watermark gap);
and any decision starts a `cooldown` tick window in which nothing new
is proposed (a reshard in flight must not be second-guessed by the
backlog spike it itself causes).

The controller PROPOSES; it never executes. `kme-torch-supervise
--groups auto` feeds it from the group heartbeats and appends each
decision to <state_root>/autoscale.json, where an operator hands the
proposal to `kme-torch-reshard`. `simulate_autoscale` replays a
recorded gauge trace through a fresh controller — same trace, same
decisions, byte-for-byte, exactly like `simulate_overload`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

SPLIT, MERGE = "split", "merge"


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Watermarks + hysteresis. Defaults pair with the serve-side
    OverloadController defaults: high_lag here matches its shedding
    watermark, so a split proposal lands before degradation does."""

    min_groups: int = 1
    max_groups: int = 8
    high_lag: float = 48.0      # any group at/above this is "hot"
    low_lag: float = 4.0        # every group below this is "cold"
    high_imbalance: float = 4.0  # max/mean lag that counts as hot
    dwell: int = 3              # consecutive ticks before a proposal
    cooldown: int = 8           # quiet ticks after any proposal

    def __post_init__(self) -> None:
        if self.min_groups < 1 or self.max_groups < self.min_groups:
            raise ValueError("need 1 <= min_groups <= max_groups")
        if not self.low_lag < self.high_lag:
            raise ValueError("need low_lag < high_lag (hysteresis gap)")
        if self.dwell < 1 or self.cooldown < 0:
            raise ValueError("need dwell >= 1 and cooldown >= 0")


def shard_imbalance(lags: Sequence[float]) -> float:
    """max/mean input lag across groups (1.0 = perfectly even; the
    gauge this controller re-derives from per-group lags)."""
    if not lags:
        return 1.0
    mean = sum(lags) / len(lags)
    if mean <= 0:
        return 1.0
    return max(lags) / mean


class AutoscaleController:
    """observe() one tick -> an optional split/merge proposal dict.

    Every field of the proposal is a pure function of the observed
    tick sequence, so any consumer can re-derive (and audit) it by
    replay. Internal state is three small counters — the dwell streaks
    and the cooldown — which is the whole memory of the policy."""

    def __init__(self, cfg: Optional[AutoscaleConfig] = None) -> None:
        self.cfg = cfg or AutoscaleConfig()
        self.hot_streak = 0
        self.cold_streak = 0
        self.cooldown_left = 0
        self.ticks = 0
        self.decisions: List[dict] = []

    def observe(self, groups: int, lags: Sequence[float],
                overload_states: Sequence[int] = (),
                tick: Optional[int] = None) -> Optional[dict]:
        """One control tick: current group count, per-group input lags,
        per-group overload state codes. Returns the proposal dict (also
        appended to self.decisions) or None."""
        cfg = self.cfg
        self.ticks += 1
        t = self.ticks if tick is None else int(tick)
        lags = [float(x) for x in lags]
        overloaded = any(int(s) > 0 for s in overload_states)
        imb = shard_imbalance(lags)
        hot = (overloaded
               or (bool(lags) and max(lags) >= cfg.high_lag)
               or (len(lags) > 1 and imb >= cfg.high_imbalance
                   and max(lags) > cfg.low_lag))
        cold = (not overloaded
                and (not lags or max(lags) < cfg.low_lag))
        self.hot_streak = self.hot_streak + 1 if hot else 0
        self.cold_streak = self.cold_streak + 1 if cold else 0
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            return None
        action = to = None
        if self.hot_streak >= cfg.dwell and groups < cfg.max_groups:
            action, to = SPLIT, min(cfg.max_groups, groups * 2)
        elif self.cold_streak >= cfg.dwell and groups > cfg.min_groups:
            action, to = MERGE, max(cfg.min_groups, groups // 2)
        if action is None:
            return None
        decision = {"tick": t, "action": action, "from": int(groups),
                    "to": int(to), "max_lag": max(lags) if lags else 0.0,
                    "imbalance": round(imb, 4),
                    "overloaded": overloaded,
                    "streak": (self.hot_streak if action == SPLIT
                               else self.cold_streak)}
        self.decisions.append(decision)
        self.hot_streak = self.cold_streak = 0
        self.cooldown_left = cfg.cooldown
        return decision


def simulate_autoscale(samples: Sequence[dict],
                       cfg: Optional[AutoscaleConfig] = None) -> dict:
    """Replay a recorded gauge trace through a fresh controller —
    the simulate_overload twin. Each sample:
    {"groups": N, "lags": [...], "overload": [...], "tick": t?}.
    Group count FOLLOWS proposals during the replay (a split's effect
    on subsequent ticks' `groups` input is part of the policy being
    audited) unless the sample pins "groups" explicitly."""
    ctl = AutoscaleController(cfg)
    groups: Optional[int] = None
    for s in samples:
        if s.get("groups") is not None:
            groups = int(s["groups"])
        elif groups is None:
            raise ValueError("first sample must carry 'groups'")
        d = ctl.observe(groups, s.get("lags", ()),
                        s.get("overload", ()), tick=s.get("tick"))
        if d is not None:
            groups = d["to"]
    return {"ticks": ctl.ticks, "decisions": list(ctl.decisions),
            "final_groups": groups}


def load_trace(path: str) -> List[dict]:
    """Read a JSONL gauge trace (one sample per line) for replay."""
    out = []
    with open(path, encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip()
            if ln:
                out.append(json.loads(ln))
    return out


def tick_event(ctl: AutoscaleController, groups: int,
               lags: Sequence[float],
               overload_states: Sequence[int],
               decision: Optional[dict]) -> dict:
    """The flight-recorder payload for one policy tick, read AFTER
    ``observe``: which hysteresis phase the controller is in
    (hot/cold dwell, post-proposal cooldown, steady), the raw inputs
    it saw, and — when this tick crossed the dwell threshold — the
    proposal itself. Pure function of controller state: the emitting
    monitor does the I/O, the policy stays byte-replayable."""
    if decision is not None:
        phase = "propose"
    elif ctl.cooldown_left > 0:
        phase = "cooldown"
    elif ctl.hot_streak > 0:
        phase = "hot-dwell"
    elif ctl.cold_streak > 0:
        phase = "cold-dwell"
    else:
        phase = "steady"
    detail = {"phase": phase, "groups": int(groups),
              "tick": ctl.ticks,
              "max_lag": round(max(lags), 3) if lags else 0.0,
              "overloaded": int(sum(1 for s in overload_states if s)),
              "hot_streak": ctl.hot_streak,
              "cold_streak": ctl.cold_streak,
              "cooldown_left": ctl.cooldown_left}
    if decision is not None:
        detail.update(action=decision["action"],
                      to=int(decision["to"]),
                      imbalance=decision.get("imbalance"))
    return detail
