"""kme_tpu_torch — the matching engine ported to PyTorch and CUDA.

A second package beside `kme_tpu` (the JAX/Pallas reference, which it
never imports). It mirrors `kme_tpu`'s module names so each counterpart
is easy to find; every Pallas kernel on a ported path becomes a kernel
written by hand for an NVIDIA Hopper card (`csrc/`), with a plain
PyTorch version beside it that runs on CPU tensors.

Ported so far, each from wire JSON to MatchOut lines: the sequential
matching engine in fixed and java mode (`runtime/seqsession.py` over
`engine/seq.py` and `csrc/seq_step.cu`), serially or pipelined
(`submit`/`collect`), and the sweep (lanes) engine on one device
(`runtime/session.py` over `runtime/sequencer.py`, `engine/lanes.py`,
`ops/rowdma.py` and `csrc/rowdma.cu`); both over the native host runtime
copied from `kme_tpu` (`native/`: router, scheduler, batch plan, wire
parser and MatchOut reconstructor in C++). Around them: checkpoints
whose files restore across packages (`runtime/checkpoint.py`,
`runtime/javasnap.py`), the host engines (`oracle/`, `native/oracle.py`)
and the serving stack (`bridge/`: broker, TCP, `MatchService`, `serve`)
with its CLI (`cli.py`); the seq fleet and the sharded lanes engine
(`parallel/`); the service's observability (`telemetry/`); the
multi-leader front, its group services and live resharding
(`bridge/front.py`, `bridge/reshard.py`); the market-data feed
(`feed/`); failover and chaos drills (`bridge/replica.py`,
`supervise.py`, `chaos.py`); the Kafka transport (`bridge/kafka.py`);
the deterministic whole-cluster simulator (`sim/`, host only); the
serial parity replica, the third implementation of the quirk-exact
semantics beside the oracle and the seq kernel's java mode
(`engine/parity.py` over `ops/tables.py` and `ops/bits.py`, plain torch
ops on the card); and the repo-native lint over the port's own source
(`analysis/`: the rule families, the lock graph, the `KME_LOCKCHECK=1`
recorder and `kme-torch-lint`). Entry points run on the card unless the
caller passes `device="cpu"`.
"""

import os as _os

if _os.environ.get("KME_LOCKCHECK") == "1":
    # opt-in lock-order recorder: it must patch threading.Lock/RLock
    # before any module of the port allocates a lock, hence here at the
    # package root (analysis/lockcheck.py; a recorder already installed
    # by the JAX package is left in place)
    from kme_tpu_torch.analysis import lockcheck as _lockcheck

    _lockcheck.install()
