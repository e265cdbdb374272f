"""Command-line entry points of the port.

`python -m kme_tpu_torch.cli <command>` or the `kme-torch-*` scripts:

- serve     — the engine service (bridge/serve.py): hosts the broker
              and runs the seq or lanes engine on the card
              (`--device cpu` for the plain versions), or the oracle /
              native host engines
- loadgen   — the exchange_test.js role: a seeded harness stream to
              stdout or produced to a broker's MatchIn
- consume   — the consumer.js role: MatchOut lines to stdout
- provision — the topic.js role: create MatchIn/MatchOut

The JAX package's other commands (bench, supervise, trace, chaos, top,
...) are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def loadgen_main(argv=None) -> int:
    """Workload generator — the exchange_test.js role: emit a seeded wire
    stream (JSON lines) to stdout or a transport."""
    p = argparse.ArgumentParser(prog="kme-torch-loadgen",
                                description=loadgen_main.__doc__)
    p.add_argument("--events", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--accounts", type=int, default=10)
    p.add_argument("--symbols", type=int, default=3)
    p.add_argument("--validate", action="store_true",
                   help="clamp prices/sizes to the fixed-mode domain")
    p.add_argument("--fix-payout-opcode", action="store_true",
                   help="emit real PAYOUT (200) instead of the reference "
                        "harness's action=4 bug (Q5)")
    p.add_argument("--broker", default=None, metavar="HOST:PORT",
                   help="produce to MatchIn on this broker instead of "
                        "printing to stdout (the exchange_test.js role)")
    p.add_argument("--connections", type=int, default=None, metavar="N",
                   help="simulated AIMD-paced clients; needs the JAX "
                        "package's telemetry/dtrace.py, not ported yet")
    p.add_argument("--tsdb-out", default=None, metavar="DIR",
                   help="client-side history sample; needs the JAX "
                        "package's telemetry/tsdb.py, not ported yet")
    args = p.parse_args(argv)
    for flag, val, mod in (("--connections", args.connections,
                            "telemetry/dtrace.py"),
                           ("--tsdb-out", args.tsdb_out,
                            "telemetry/tsdb.py")):
        if val is not None:
            p.error(f"{flag} needs the JAX package's {mod}, which "
                    f"kme_tpu_torch does not have yet (ROADMAP.md, "
                    f"Queue A item 6)")
    from kme_tpu_torch.wire import dumps_order
    from kme_tpu_torch.workload import harness_stream

    msgs = harness_stream(args.events, seed=args.seed,
                          num_accounts=args.accounts,
                          num_symbols=args.symbols,
                          payout_opcode_bug=not args.fix_payout_opcode,
                          validate=args.validate)
    if args.broker is not None:
        import time

        from kme_tpu_torch.bridge.broker import BrokerOverload
        from kme_tpu_torch.bridge.provision import provision
        from kme_tpu_torch.bridge.service import TOPIC_IN
        from kme_tpu_torch.bridge.tcp import TcpBroker, parse_addr

        host, port = parse_addr(args.broker)
        client = TcpBroker(host, port)
        shed = 0
        try:
            provision(client)  # idempotent: both topics must exist
            lo = 0
            while lo < len(msgs):
                try:
                    client.produce_batch(
                        TOPIC_IN, [(None, dumps_order(m))
                                   for m in msgs[lo:lo + 4096]])
                except BrokerOverload as e:
                    # bounded ingress: the broker sheds load instead of
                    # growing the backlog — back off (honoring the AIMD
                    # hint when there is one) and re-offer the batch
                    # from the broker's durable high-water mark
                    shed += 1
                    hint = getattr(e, "backoff_ms", None)
                    time.sleep(hint / 1e3 if hint else 0.1)
                    lo = client.end_offset(TOPIC_IN)
                    continue
                lo += 4096
        finally:
            client.close()
        note = f" ({shed} overload backoffs)" if shed else ""
        print(f"kme-loadgen: produced {len(msgs)} records to MatchIn"
              f"{note}", file=sys.stderr)
        return 0
    for m in msgs:
        print(dumps_order(m))
    return 0


def serve_main(argv=None) -> int:
    from kme_tpu_torch.bridge.serve import main as _main

    return _main(argv)


def consume_main(argv=None) -> int:
    from kme_tpu_torch.bridge.consume import main as _main

    return _main(argv)


def provision_main(argv=None) -> int:
    from kme_tpu_torch.bridge.provision import main as _main

    return _main(argv)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m kme_tpu_torch.cli")
    p.add_argument("command", choices=("serve", "loadgen", "consume",
                                       "provision"))
    args, rest = p.parse_known_args(argv)
    try:
        return {"serve": serve_main, "loadgen": loadgen_main,
                "consume": consume_main,
                "provision": provision_main}[args.command](rest)
    except BrokenPipeError:
        # downstream closed the pipe (e.g. `| head`): point both std
        # streams at devnull so interpreter-shutdown flushes cannot
        # re-raise on the broken descriptors
        import os

        fd = os.open(os.devnull, os.O_WRONLY)
        os.dup2(fd, sys.stdout.fileno())
        os.dup2(fd, sys.stderr.fileno())
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
