"""Deterministic whole-cluster simulation: the port of `kme_tpu/sim/`.

FoundationDB-style simulation testing for the matching cluster: the
supervisor's whole process tree — N group leaders, standby followers,
the front router, the feed deriver — runs in ONE process as
cooperatively scheduled actors under a virtual clock, with a seeded
``SimScheduler`` owning every source of nondeterminism:

- the clock (``bridge/clock.py`` seam — no component reads wall time),
- actor interleaving (seeded quantum jitter),
- message delivery order/delay on the in-memory transport
  (``net.partition`` / ``net.delay`` / ``net.reorder`` fault points),
- and a generated fault schedule (crash, SIGKILL-at-offset, torn
  checkpoint, broker errors, storm bursts, reshard mid-storm) drawn
  from the ``faults.py`` point grammar.

One seed fully determines a run: same seed → byte-identical event
trace, byte-identical durable MatchOut, identical verdicts. A red seed
is automatically shrunk (``shrink.py`` delta-debugging over the fault
schedule and the input stream) to a minimal one-line repro that
replays offline with no live cluster.

Host code: the leaders and standbys run the oracle engine, as in the
JAX package, so one seed gives the same trace and MatchOut digests in
both packages.

Entry points: ``kme-torch-sim`` (cli.py), ``run_sim`` below.
"""

from kme_tpu_torch.sim.cluster import SimConfig, SimResult, run_sim  # noqa: F401
from kme_tpu_torch.sim.schedule import (FaultSchedule,  # noqa: F401
                                  generate_schedule)
from kme_tpu_torch.sim.shrink import shrink_schedule  # noqa: F401
