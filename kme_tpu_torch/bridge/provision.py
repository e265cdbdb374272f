"""Topic provisioner — the topic.js role (the reference's topic.js:14-25):
create `MatchIn` and `MatchOut`, one partition each, against a broker."""

from __future__ import annotations

import argparse

from kme_tpu_torch.bridge.service import TOPIC_IN, TOPIC_OUT


def provision(broker, topics=None) -> dict:
    """Create the topics (default: the classic MatchIn/MatchOut pair);
    returns {topic: created?}."""
    return {t: broker.create_topic(t, partitions=1)
            for t in (topics or (TOPIC_IN, TOPIC_OUT))}


def group_topics(k: int) -> tuple:
    """The namespaced durable topics of shard group k (bridge/service.py
    --group mode): its input/output substreams plus the stamped
    cross-shard transfer evidence log."""
    return (f"{TOPIC_IN}.g{k}", f"{TOPIC_OUT}.g{k}", f"Xfer.g{k}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kme-torch-provision", description=__doc__)
    p.add_argument("--broker", default="127.0.0.1:9092",
                   metavar="HOST:PORT",
                   help="broker address (a running kme-torch-serve)")
    p.add_argument("--group", default=None, metavar="K/N",
                   help="provision shard group K's namespaced topics "
                        "(MatchIn.gK/MatchOut.gK/Xfer.gK) instead of "
                        "the classic pair")
    args = p.parse_args(argv)
    from kme_tpu_torch.bridge.tcp import TcpBroker, parse_addr

    host, port = parse_addr(args.broker)
    topics = None
    if args.group is not None:
        k = int(args.group.split("/", 1)[0])
        topics = group_topics(k)
    client = TcpBroker(host, port)
    try:
        for topic, created in provision(client, topics=topics).items():
            state = "created" if created else "exists"
            print(f"{topic}: {state} (partitions=1)")
    finally:
        client.close()
    return 0
