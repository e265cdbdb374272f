"""Transport bridge of the port: copies of `kme_tpu/bridge/`'s serving
stack.

- broker.py   — the broker core: named topics, single-partition ordered
                logs, offset-based fetch, the durable log (persist_dir),
                exactly-once stamps, fencing and bounded ingress.
- tcp.py      — the process boundary: JSON-lines and binary produce on
                one socket (serve_broker / TcpBroker).
- service.py  — MatchService: polls MatchIn, runs the seq or lanes
                engine on the card (or the oracle / native host engines),
                forwards the IN/OUT record stream to MatchOut.
- provision.py/serve.py/consume.py — the CLI roles.
- clock.py, lease.py — the time seam and the leader-epoch lease.
- replica.py  — the hot-standby replica (kme-torch-standby): follows
                the leader's durable MatchIn log one batch behind,
                takes over at the next epoch when promoted.
- supervise.py — kme-torch-supervise: restarts a failed serve child or
                promotes the standby; `--groups N|auto` runs a pair per
                group under autoscale.py's split/merge policy.
- chaos.py    — kme-torch-chaos: seeded fault-injection drills and
                overload storms against supervised serve children,
                verified byte for byte against the oracle.
- kafka.py    — the broker surface over a Kafka cluster (aiokafka,
                optional): kme-torch-serve --kafka.
"""

from kme_tpu_torch.bridge.broker import BrokerError, InProcessBroker, Record

__all__ = ["BrokerError", "InProcessBroker", "Record"]
