"""The port's Kafka transport (`kme_tpu_torch/bridge/kafka.py`),
`kme-torch-serve --kafka` and `kme-torch-oracle`.

aiokafka is not installed here and no Kafka broker runs, so a minimal
in-memory stand-in for the client surface the adapter calls (producer,
consumer with assign/seek/getmany/end_offsets, admin, TopicPartition)
takes its place, as tests/test_kafka_adapter.py does for the JAX
package. What is pinned is the adapter's own logic (offsets across
seeks, key/value codecs, partition-0 pinning, create-topic semantics),
the port's service over it against the JAX package's service over the
JAX package's adapter, the serve CLI's Kafka branch, and the oracle
CLI's stdout against `kme-oracle`'s.
"""

import io
import sys
import types

import pytest
import torch

from kme_tpu.bridge.kafka import KafkaBroker as JKafkaBroker
from kme_tpu.bridge.provision import provision as jprovision
from kme_tpu.bridge.service import MatchService as JMatchService
from kme_tpu.oracle import OracleEngine as JOracleEngine
from kme_tpu_torch.bridge.broker import BrokerError
from kme_tpu_torch.bridge.kafka import KafkaBroker
from kme_tpu_torch.bridge.provision import provision
from kme_tpu_torch.bridge.service import MatchService
from kme_tpu_torch.wire import dumps_order
from kme_tpu_torch.workload import harness_stream, zipf_symbol_stream

torch.set_num_threads(1)

TOPIC_IN, TOPIC_OUT = "MatchIn", "MatchOut"
SMALL = dict(batch=32, symbols=8, accounts=16, slots=128, max_fills=32)


# ---------------------------------------------------------------------------
# the aiokafka stand-in


class _TP:
    def __init__(self, topic, partition):
        self.topic, self.partition = topic, partition

    def __hash__(self):
        return hash((self.topic, self.partition))

    def __eq__(self, o):
        return (self.topic, self.partition) == (o.topic, o.partition)


class _Msg:
    def __init__(self, offset, key, value):
        self.offset, self.key, self.value = offset, key, value


class _Meta:
    def __init__(self, offset):
        self.offset = offset


class _Cluster:
    def __init__(self):
        self.logs = {}          # topic -> list[(key bytes, value bytes)]
        self.partitions = []    # the partition of every send


class _Producer:
    def __init__(self, cluster, **kw):
        self._c = cluster

    async def start(self):
        pass

    async def stop(self):
        pass

    async def flush(self):
        pass

    async def send_and_wait(self, topic, value, key=None, partition=None):
        self._c.partitions.append(partition)
        log = self._c.logs.setdefault(topic, [])
        log.append((key, value))
        return _Meta(len(log) - 1)


class _Consumer:
    def __init__(self, cluster, **kw):
        self._c = cluster
        self._pos = {}

    async def start(self):
        pass

    async def stop(self):
        pass

    def assign(self, tps):
        for tp in tps:
            assert tp.partition == 0
            self._pos.setdefault(tp, 0)

    def seek(self, tp, offset):
        self._pos[tp] = offset

    async def getmany(self, *tps, timeout_ms=0, max_records=1024):
        out = {}
        for tp in tps:
            log = self._c.logs.get(tp.topic, [])
            pos = self._pos.get(tp, 0)
            msgs = [_Msg(o, k, v)
                    for o, (k, v) in enumerate(log[pos:pos + max_records],
                                               start=pos)]
            if msgs:
                self._pos[tp] = msgs[-1].offset + 1
                out[tp] = msgs
        return out

    async def end_offsets(self, tps):
        return {tp: len(self._c.logs.get(tp.topic, [])) for tp in tps}


class _Admin:
    def __init__(self, cluster, **kw):
        self._c = cluster

    async def start(self):
        pass

    async def close(self):
        pass

    async def list_topics(self):
        return list(self._c.logs)

    async def create_topics(self, news):
        for n in news:
            self._c.logs.setdefault(n.name, [])


class _NewTopic:
    def __init__(self, name, num_partitions, replication_factor):
        self.name = name


def _install_stand_in(monkeypatch):
    """A fresh in-memory cluster behind a stand-in `aiokafka`; a broker
    keeps the module it was constructed with, so two brokers built
    after two installs talk to two clusters."""
    cluster = _Cluster()
    mod = types.ModuleType("aiokafka")
    mod.TopicPartition = _TP
    mod.AIOKafkaProducer = lambda **kw: _Producer(cluster, **kw)
    mod.AIOKafkaConsumer = lambda **kw: _Consumer(cluster, **kw)
    admin = types.ModuleType("aiokafka.admin")
    admin.AIOKafkaAdminClient = lambda **kw: _Admin(cluster, **kw)
    admin.NewTopic = _NewTopic
    mod.admin = admin
    monkeypatch.setitem(sys.modules, "aiokafka", mod)
    monkeypatch.setitem(sys.modules, "aiokafka.admin", admin)
    return cluster


def _oracle_lines(msgs, **kw):
    ora = JOracleEngine("fixed", book_slots=kw["slots"],
                        max_fills=kw["max_fills"])
    out = []
    for m in msgs:
        for r in ora.process(m.copy()):
            out.append(f"{r.key} {dumps_order(r.msg)}"
                       if hasattr(r, "msg") else r.wire())
    return out


# ---------------------------------------------------------------------------


def test_kafka_adapter_contract(monkeypatch):
    cluster = _install_stand_in(monkeypatch)
    b = KafkaBroker("fake:9092")
    assert b.create_topic(TOPIC_IN) is True
    assert b.create_topic(TOPIC_IN) is False        # kafkajs semantics
    assert b.create_topic(TOPIC_OUT) is True
    assert set(b.topics()) == {TOPIC_IN, TOPIC_OUT}

    assert b.produce(TOPIC_IN, None, "a") == 0
    assert b.produce(TOPIC_IN, "IN", "b") == 1
    assert b.end_offset(TOPIC_IN) == 2
    recs = b.fetch(TOPIC_IN, 0)
    assert [(r.offset, r.key, r.value) for r in recs] == [
        (0, None, "a"), (1, "IN", "b")]
    # re-fetch from an arbitrary offset (seek path)
    recs = b.fetch(TOPIC_IN, 1)
    assert [(r.offset, r.value) for r in recs] == [(1, "b")]
    # sequential fetch continues without a seek
    b.produce(TOPIC_IN, None, "c")
    recs = b.fetch(TOPIC_IN, 2)
    assert [(r.offset, r.value) for r in recs] == [(2, "c")]
    # bytes on the wire, every send pinned to partition 0
    assert cluster.logs[TOPIC_IN] == [(None, b"a"), (b"IN", b"b"),
                                      (None, b"c")]
    assert cluster.partitions == [0, 0, 0]
    b.sync()
    b.close()


def test_kafka_broker_needs_aiokafka(monkeypatch):
    """Importing the module needs no aiokafka; constructing the broker
    without it raises BrokerError naming the package."""
    monkeypatch.setitem(sys.modules, "aiokafka", None)
    with pytest.raises(BrokerError, match="aiokafka"):
        KafkaBroker("k:1")


def test_match_service_over_kafka_adapter(monkeypatch):
    """The full engine loop against the Kafka transport surface:
    provision, produce the harness stream, run MatchService, and the
    MatchOut stream must equal the oracle's byte for byte."""
    _install_stand_in(monkeypatch)
    msgs = harness_stream(300, seed=9, num_symbols=4, num_accounts=8,
                          payout_opcode_bug=False, validate=True)
    b = KafkaBroker("fake:9092")
    provision(b)
    for m in msgs:
        b.produce(TOPIC_IN, None, dumps_order(m))
    svc = MatchService(b, engine="oracle", compat="fixed", **SMALL)
    assert svc.run(max_messages=len(msgs)) == len(msgs)
    svc.close()
    out = b.fetch(TOPIC_OUT, 0, max_records=10_000)
    assert [f"{r.key} {r.value}" for r in out] == _oracle_lines(msgs,
                                                                **SMALL)
    b.close()


def _served(broker_cls, provision_fn, service_cls, lines, **kw):
    b = broker_cls("fake:9092")
    provision_fn(b)
    for ln in lines:
        b.produce(TOPIC_IN, None, ln)
    svc = service_cls(b, **kw)
    assert svc.run(max_messages=len(lines)) == len(lines)
    svc.close()
    out = [(r.offset, r.key, r.value)
           for r in b.fetch(TOPIC_OUT, 0, max_records=1 << 20)]
    b.close()
    return out


@pytest.mark.parametrize("engine", ["seq", "oracle"])
def test_service_over_kafka_equals_jax_package(monkeypatch, engine):
    """One seeded stream (PAYOUTs included) through the port's service
    over the port's adapter (the seq engine's plain version on the CPU,
    or the oracle) and through the JAX package's oracle service over the
    JAX package's adapter, each with a cluster of its own: the same
    MatchOut records, offsets and keys included."""
    lines = [dumps_order(m) for m in zipf_symbol_stream(
        600, num_symbols=8, num_accounts=16, seed=4, payout_per_mille=10)]
    _install_stand_in(monkeypatch)
    kw = dict(SMALL, engine=engine, compat="fixed")
    if engine == "seq":
        kw["device"] = "cpu"
    got = _served(KafkaBroker, provision, MatchService, lines, **kw)
    _install_stand_in(monkeypatch)
    want = _served(JKafkaBroker, jprovision, JMatchService, lines,
                   **dict(SMALL, engine="oracle", compat="fixed"))
    assert got == want and len(got) > len(lines)


def test_serve_cli_over_kafka(monkeypatch, tmp_path, capsys):
    """`kme-torch-serve --kafka`: no TCP listener, the topics provisioned
    in the cluster, the stream served by the seq engine (plain version),
    and with --checkpoint-dir the output falls back to at-least-once,
    loudly."""
    from kme_tpu_torch.bridge import serve

    cluster = _install_stand_in(monkeypatch)
    msgs = harness_stream(200, seed=2, num_symbols=4, num_accounts=8,
                          payout_opcode_bug=False, validate=True)
    cluster.logs[TOPIC_IN] = [(None, dumps_order(m).encode())
                              for m in msgs]
    rc = serve.main(["--kafka", "fake:9092", "--engine", "seq",
                     "--device", "cpu", "--auto-provision",
                     "--batch", "32", "--symbols", "8", "--accounts", "16",
                     "--slots", "128", "--max-fills", "32",
                     "--checkpoint-dir", str(tmp_path / "ck"),
                     "--max-messages", str(len(msgs))])
    assert rc == 0
    err = capsys.readouterr().err
    assert "using Kafka at fake:9092" in err
    assert "falling back to at-least-once" in err
    assert "listening" not in err
    assert {TOPIC_IN, TOPIC_OUT} <= set(cluster.logs)
    got = [f"{k.decode()} {v.decode()}" for k, v in cluster.logs[TOPIC_OUT]]
    assert got == _oracle_lines(msgs, slots=128, max_fills=32)


@pytest.mark.parametrize("compat", ["java", "fixed"])
def test_oracle_cli_equals_kme_oracle(monkeypatch, capsys, compat):
    """`kme-torch-oracle` prints what `kme-oracle` prints, byte for byte,
    for a harness stream with PAYOUTs and blank lines in it."""
    from kme_tpu.cli import oracle_main as joracle_main
    from kme_tpu_torch.cli import main

    msgs = harness_stream(400, seed=7, num_symbols=4, num_accounts=8)
    text = "\n".join(dumps_order(m) for m in msgs[:200]) + "\n\n" + \
        "\n".join(dumps_order(m) for m in msgs[200:]) + "\n"
    outs = []
    for fn, argv in ((main, ["oracle"]), (joracle_main, [])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        assert fn(argv + ["--compat", compat]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[0].count("\n") > len(msgs)


def test_oracle_cli_defaults_to_java(monkeypatch, capsys):
    from kme_tpu_torch.cli import oracle_main

    msgs = harness_stream(100, seed=1)
    text = "".join(dumps_order(m) + "\n" for m in msgs)
    outs = []
    for argv in ([], ["--compat", "java"]):
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        assert oracle_main(argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


def test_card_kafka_prefix_constant():
    """tests/test_torch_cuda.py holds the Kafka-served card service to a
    recorded MatchOut of a prefix of chip_smoke.py's zipf stream: the JAX
    package's oracle gives it."""
    import hashlib
    import importlib.util
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "torch_cuda_cases", os.path.join(root, "test_torch_cuda.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(root), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    msgs = zipf_symbol_stream(**smoke.STREAM)[:cases.KAFKA_PREFIX]
    lines = _oracle_lines(msgs, slots=smoke.SERVE["slots"],
                          max_fills=smoke.SERVE["max_fills"])
    h = hashlib.sha256()
    for ln in lines:
        h.update(ln.encode() + b"\n")
    assert (len(lines), h.hexdigest()) == cases.KAFKA_PREFIX_MATCHOUT
