"""Kafka-client transport: the broker API against a real Kafka cluster.

The port of `kme_tpu/bridge/kafka.py`: host code, no torch. The
in-process broker + TCP protocol is the CI/serving path; THIS
adapter implements the same five-method broker surface
(create_topic / topics / produce / fetch / end_offset, plus sync) over
aiokafka, so where a real Kafka broker exists the reference's own
clients — kafkajs in topic.js:8, exchange_test.js:6-12, consumer.js:6-13
— connect to the SAME topics the engine serves, and the unmodified Node
harness drives the engine end-to-end:

    kafka-server-start ...                      # real broker :9092
    node topic.js                               # or: kme-torch-provision
    kme-torch-serve --kafka localhost:9092 &    # the engine on the card
    node exchange_test.js ; node consumer.js    # unmodified harness

aiokafka is an OPTIONAL dependency: importing this module works without
it; constructing KafkaBroker raises a clear error when absent. The
adapter's own logic (offset bookkeeping, key/value codecs, partition-0
pinning, blocking-fetch semantics) is pinned by contract tests against
a faked aiokafka (tests/test_torch_kafka.py) so the CI path never
needs a broker.

Single-partition topics, like the reference (topic.js:18,22): the
engine's ordering contract is the partition order of partition 0.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from kme_tpu_torch.bridge.broker import BrokerError, Record


def _aiokafka():
    try:
        import aiokafka
        import aiokafka.admin
    except ImportError as e:  # pragma: no cover - env-dependent
        raise BrokerError(
            "the Kafka transport needs the optional aiokafka package "
            "(pip install aiokafka); the in-process broker + TCP bridge "
            "needs no external dependencies") from e
    return aiokafka


class KafkaBroker:
    """Broker-API adapter over aiokafka (sync facade; a private event
    loop runs the async client calls)."""

    def __init__(self, bootstrap: str = "localhost:9092") -> None:
        self._k = _aiokafka()
        self.bootstrap = bootstrap
        self._loop = asyncio.new_event_loop()
        self._producer = None
        self._admin = None
        self._consumers: Dict[str, object] = {}
        self._positions: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def _run(self, coro):
        return self._loop.run_until_complete(coro)

    def _make(self, factory):
        """Construct a client INSIDE the private loop: aiokafka >= 0.8
        dropped the loop= kwarg and resolves the running loop itself."""
        async def mk():
            return factory()

        return self._run(mk())

    def _get_producer(self):
        if self._producer is None:
            p = self._make(lambda: self._k.AIOKafkaProducer(
                bootstrap_servers=self.bootstrap))
            self._run(p.start())
            self._producer = p
        return self._producer

    def _get_consumer(self, topic: str):
        c = self._consumers.get(topic)
        if c is None:
            c = self._make(lambda: self._k.AIOKafkaConsumer(
                bootstrap_servers=self.bootstrap,
                enable_auto_commit=False, auto_offset_reset="earliest"))
            self._run(c.start())
            tp = self._k.TopicPartition(topic, 0)
            c.assign([tp])
            self._consumers[topic] = c
            self._positions[topic] = -1
        return c

    def _tp(self, topic: str):
        return self._k.TopicPartition(topic, 0)

    # -------------------------------------------------- broker surface
    def _get_admin(self):
        if self._admin is None:
            a = self._make(lambda: self._k.admin.AIOKafkaAdminClient(
                bootstrap_servers=self.bootstrap))
            self._run(a.start())
            self._admin = a
        return self._admin

    def create_topic(self, name: str, partitions: int = 1) -> bool:
        """kafkajs admin.createTopics semantics (topic.js:14-25):
        False when the topic already exists."""
        admin = self._get_admin()
        existing = self._run(admin.list_topics())
        if name in existing:
            return False
        new = self._k.admin.NewTopic(
            name=name, num_partitions=partitions, replication_factor=1)
        self._run(admin.create_topics([new]))
        return True

    def topics(self) -> Dict[str, int]:
        return {t: 1 for t in self._run(self._get_admin().list_topics())
                if not t.startswith("__")}

    def produce(self, topic: str, key: Optional[str], value: str) -> int:
        p = self._get_producer()
        md = self._run(p.send_and_wait(
            topic, value.encode("utf-8"),
            key=None if key is None else key.encode("utf-8"),
            partition=0))
        return md.offset

    def fetch(self, topic: str, offset: int, max_records: int = 1024,
              timeout: float = 0.0) -> List[Record]:
        c = self._get_consumer(topic)
        tp = self._tp(topic)
        if self._positions.get(topic) != offset:
            c.seek(tp, offset)          # aiokafka's seek is synchronous
            self._positions[topic] = offset
        batches = self._run(c.getmany(
            tp, timeout_ms=max(int(timeout * 1000), 0),
            max_records=max_records))
        recs = []
        for msgs in batches.values():
            for m in msgs:
                recs.append(Record(
                    offset=m.offset,
                    key=None if m.key is None else m.key.decode("utf-8"),
                    value=m.value.decode("utf-8")))
        if recs:
            self._positions[topic] = recs[-1].offset + 1
        return recs

    def end_offset(self, topic: str) -> int:
        c = self._get_consumer(topic)
        tp = self._tp(topic)
        ends = self._run(c.end_offsets([tp]))
        return ends[tp]

    def sync(self) -> None:
        if self._producer is not None:
            self._run(self._producer.flush())

    def close(self) -> None:
        for c in self._consumers.values():
            self._run(c.stop())
        self._consumers.clear()
        if self._producer is not None:
            self._run(self._producer.stop())
            self._producer = None
        if self._admin is not None:
            self._run(self._admin.close())
            self._admin = None
