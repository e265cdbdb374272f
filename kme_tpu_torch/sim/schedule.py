"""Generative fault schedules: what one seed makes the cluster endure.

A ``FaultSchedule`` is the COMPLETE description of a simulated run's
adversity, in two layers:

- ``clauses`` — KME_FAULTS grammar clauses (``faults.py``), installed
  via ``faults.configure`` for the run.  These drive the per-call-site
  points: broker errors, torn/bitflipped checkpoints, transport
  partitions/delays/reorder-dups, clock skew.  The offset domain for
  ``at=`` gates is the transport's global delivery ordinal.
- ``events`` — cluster-level acts the harness performs at input-stream
  positions: ``crash`` a group leader (drop its process state, recover
  from durables), splice a ``storm`` burst into the workload, or
  ``reshard`` the cluster N→M mid-run through the real offline
  coordinator.

The schedule also owns the workload size (``num_events``) and topology
(``ngroups``) so that a serialized schedule is a fully self-contained
repro: ``kme-torch-sim --repro file.json`` needs nothing else.

``generate_schedule(seed)`` draws all of it from
``random.Random((seed, "sim-schedule"))`` — an independent stream, so
adding a knob here never perturbs the scheduler's interleaving stream.
Serialization is canonical JSON (sorted keys, no spaces): one line, fit
for a failure report or a shell history.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import List, Optional

from kme_tpu_torch.workload import STORM_PROFILES

# grammar points the generator may draw (the sim-safe subset: no
# serve.kill / journal.torn / tcp.* — those SIGKILL or require a live
# TCP server, which in a single-process sim would kill the sim itself;
# crashes are modeled as `crash` EVENTS instead, which exercise the
# same recovery path without taking the harness down with them)
SIM_POINTS = ("broker.produce", "broker.fetch", "ckpt.torn",
              "ckpt.bitflip", "net.partition", "net.delay",
              "net.reorder", "clock.skew")

_MS_CHOICES = (20, 50, 100, 250)

# storm profiles the generator may splice. The PAYOUT-settlement
# profiles (liquidation-cascade, payout-storm-wide) are excluded:
# payout credits land at the SYMBOL's group engine, which the front's
# shadow-cash margin bound cannot see, so grouped parity does not hold
# for them even with zero transfer shortfall — a documented limitation
# of grouped serving, not a cluster bug the sweep should re-find on
# every third seed. `kme-torch-sim --profile` can still force one
# explicitly.
SIM_STORMS = ("cancel-storm", "flash-crowd", "hot-book")
assert all(s in STORM_PROFILES for s in SIM_STORMS)


@dataclass
class FaultSchedule:
    seed: int
    clauses: List[str] = field(default_factory=list)
    events: List[dict] = field(default_factory=list)
    num_events: int = 400
    ngroups: int = 2

    # -- serialization (canonical, one line) ---------------------------

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "clauses": self.clauses,
             "events": self.events, "num_events": self.num_events,
             "ngroups": self.ngroups},
            sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        d = json.loads(text)
        return cls(seed=int(d["seed"]),
                   clauses=list(d.get("clauses", [])),
                   events=list(d.get("events", [])),
                   num_events=int(d.get("num_events", 400)),
                   ngroups=int(d.get("ngroups", 2)))

    def spec(self) -> Optional[str]:
        """The KME_FAULTS string for ``faults.configure`` (None = calm)."""
        if not self.clauses:
            return None
        return ";".join([f"seed={self.seed}"] + list(self.clauses))

    def describe(self) -> str:
        bits = [f"seed={self.seed}", f"n={self.num_events}",
                f"groups={self.ngroups}"]
        bits.extend(self.clauses)
        for ev in self.events:
            kv = ",".join(f"{k}={v}" for k, v in sorted(ev.items())
                          if k != "kind")
            bits.append(f"{ev['kind']}[{kv}]" if kv else ev["kind"])
        return " ".join(bits)

    def size(self) -> int:
        """Shrink metric: total adversity count."""
        return len(self.clauses) + len(self.events)


def generate_schedule(seed: int, num_events: int = 400,
                      ngroups: int = 2,
                      profile: Optional[str] = None) -> FaultSchedule:
    """Draw a schedule for ``seed``.  Every draw comes from one seeded
    stream in a FIXED order, so schedule generation is reproducible and
    two seeds give genuinely different adversity mixes."""
    rng = random.Random((int(seed), "sim-schedule").__repr__())
    sched = FaultSchedule(seed=int(seed), num_events=num_events,
                          ngroups=ngroups)

    # grammar clauses: 1..4 point rules gated over the run.  net.* and
    # clock.skew call sites pass an offset (the delivery ordinal /
    # applied input offset), so `at=` gates work; broker.* and ckpt.*
    # production call sites pass NO offset, so only hit-count gates
    # (`after=`) ever fire there — at= would silently never trigger.
    for _ in range(rng.randint(1, 4)):
        point = rng.choice(SIM_POINTS)
        if point.startswith("net.") or point == "clock.skew":
            gate = f"at={rng.randrange(1, max(2, num_events))}"
        else:
            gate = f"after={rng.randrange(1, max(2, num_events))}"
        parts = [point, "n=1", gate]
        if point.startswith("net.") or point == "clock.skew":
            parts.append(f"ms={rng.choice(_MS_CHOICES)}")
        if point == "ckpt.torn":
            parts.append(f"frac={rng.choice((0.25, 0.5, 0.75))}")
        sched.clauses.append(":".join(parts))

    # a leader crash + recovery, most runs (the core robustness drill)
    if rng.random() < 0.6:
        sched.events.append({
            "kind": "crash",
            "group": rng.randrange(ngroups),
            "at": rng.randrange(num_events // 4,
                                max(num_events // 4 + 1,
                                    3 * num_events // 4)),
        })

    # a storm burst spliced into the harness stream
    if rng.random() < 0.5:
        name = profile or rng.choice(SIM_STORMS)
        sched.events.append({
            "kind": "storm",
            "profile": name,
            "at": rng.randrange(num_events // 4,
                                max(num_events // 4 + 1,
                                    3 * num_events // 4)),
            "n": rng.choice((50, 100, 150)),
        })

    # a mid-run reshard (drain -> offline coordinator -> reopen).
    # Targets stay >= 2: the sim cluster is grouped serving throughout
    # (group=(k, m) topic namespacing needs m > 1).
    if rng.random() < 0.3:
        to = rng.choice([m for m in (2, 3, 4) if m != ngroups])
        sched.events.append({
            "kind": "reshard",
            "at": rng.randrange(num_events // 3,
                                max(num_events // 3 + 1,
                                    2 * num_events // 3)),
            "to": to,
        })

    # deterministic event order: by stream position, then kind
    sched.events.sort(key=lambda e: (e.get("at", 0), e["kind"]))
    return sched
