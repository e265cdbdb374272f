"""A traffic mix, read from its data file (`kmebench/traffic/<mix>.json`):
when each message of the window is due, how many may be outstanding, and
how many go in one produce call. The generator child sends at these due
times and the harness times each message from the same function, so the
two never disagree.

The keys of a mix file:

- `arrivals`: `"poisson"`, exponential gaps at the cell's `rate_per_s`,
  scaled by `shape`. Without it the mix is a closed loop: each message
  is due as soon as `outstanding_batches` lets it go, and no latency is
  taken from a schedule.
- `shape` (`[[1, 1]]`): a cycle of `[seconds, multiplier]` segments,
  repeated through the window; inside a segment the rate is
  `rate_per_s` times its multiplier (`[[9, 0.9], [1, 1.9]]`: a burst
  of 1.9 times the rate one second in ten, the mean kept).
- `outstanding_batches`: at most this many batches produced and not yet
  answered at the consumer (the closed loop keeps it full).
- `per_call_batches`: at most this many batches in one produce call;
  without it every message due goes in one call.
- `tick_ms` (1): the generator wakes at these boundaries and sends what
  is due in one call, as a Kafka producer batches under `linger.ms`.
- `why`: one line, for the reader.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kmebench.streams import rng_for

KEYS = {"arrivals", "shape", "outstanding_batches", "per_call_batches",
        "tick_ms", "why"}
UNBOUNDED = 1 << 62


def check(mix: dict) -> None:
    unknown = set(mix) - KEYS
    if unknown:
        raise ValueError(f"unknown traffic keys {sorted(unknown)}")
    if mix.get("arrivals", "poisson") != "poisson":
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    if "arrivals" not in mix and "outstanding_batches" not in mix:
        raise ValueError("a mix without arrivals needs outstanding_batches")
    for seg in mix.get("shape", [[1, 1]]):
        if len(seg) != 2 or seg[0] <= 0 or seg[1] <= 0:
            raise ValueError(f"a shape segment is [seconds > 0, "
                             f"multiplier > 0], not {seg}")


def outstanding(mix: dict, batch: int) -> int:
    n = mix.get("outstanding_batches")
    return UNBOUNDED if n is None else int(n) * batch


def per_call(mix: dict, batch: int) -> int:
    n = mix.get("per_call_batches")
    return UNBOUNDED if n is None else int(n) * batch


def tick_s(mix: dict) -> float:
    return float(mix.get("tick_ms", 1)) / 1e3


def due_offsets(mix: dict, params: dict, seed: int,
                seconds: float) -> Optional[np.ndarray]:
    """Due times (seconds from the window's start, ascending, all below
    `seconds`) of the window's messages, or None for a closed loop."""
    check(mix)
    if "arrivals" not in mix:
        return None
    rate = float(params["rate_per_s"])
    if rate <= 0:
        raise ValueError("rate_per_s must be positive")
    shape = np.asarray(mix.get("shape", [[1, 1]]), np.float64)
    # the cumulative expected count L(t) at the shape's breakpoints,
    # over as many cycles as the window holds
    cycles = int(np.ceil(seconds / shape[:, 0].sum())) + 1
    dur = np.tile(shape[:, 0], cycles)
    t = np.concatenate([[0.0], np.cumsum(dur)])
    mass = np.concatenate([[0.0], np.cumsum(dur * np.tile(shape[:, 1],
                                                          cycles) * rate)])
    end = float(np.interp(seconds, t, mass))
    # unit-rate Poisson arrival counts u, mapped back through L^-1
    g, parts, last = rng_for(seed, 2), [], 0.0
    while last < end:
        c = last + np.cumsum(g.exponential(1.0, 4096))
        parts.append(c)
        last = float(c[-1])
    u = np.concatenate(parts)
    offs = np.interp(u[u < end], mass, t)
    return offs[offs < seconds]
