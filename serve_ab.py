"""Time the port's pipelined seq service over TCP for one or more source
trees on one NVIDIA card, in the order given.

    python3 serve_ab.py PARENT . . PARENT    # two trees, alternated

The run is `chip_smoke.py` phase 10a's serve-tcp cell with every
observability option off: the zipf stream (109,427 messages) produced
over TCP, `MatchService(engine="seq", pipeline=2)` at the kme-serve
defaults, its MatchOut consumed over TCP and held to B1's digest. Each
tree runs in a process of its own, with that tree first on `sys.path`
and its seq kernel built and warmed before the clock starts. One JSON
line per run: the tree, the service wall, its spans (serve_engine,
serve_produce, serve_observe, the rest), the dispatches, and the seconds
spent in `MatchService._stamp_orders` (null, as serve_observe, where the
tree has none). Then the card's name and power limit. Exits non-zero if
any run fails.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

STREAM = dict(num_events=100_000, num_symbols=1024, num_accounts=4096, seed=0,
              payout_per_mille=2)
SERVE = dict(symbols=1024, accounts=4096, slots=128, max_fills=16,
             batch=1024)
B1_MATCHOUT = (
    345_906, "454c29e38f8cc5b8e836f831c5479189c974cdec09800e74e84eaf8f1372a772")


def one(tree: str) -> dict:
    """The serve-tcp run of the package in `tree`."""
    tree = os.path.abspath(tree)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    import torch
    from kme_tpu_torch import native
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.consume import consume_lines
    from kme_tpu_torch.bridge.provision import provision
    from kme_tpu_torch.bridge.service import TOPIC_IN, MatchService
    from kme_tpu_torch.bridge.tcp import TcpBroker, serve_broker
    from kme_tpu_torch.engine import seq as SQ
    from kme_tpu_torch.runtime.seqsession import SeqSession
    from kme_tpu_torch.wire import dumps_order
    from kme_tpu_torch.workload import zipf_symbol_stream
    import kme_tpu_torch

    if not os.path.abspath(kme_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {kme_tpu_torch.__file__}, not {tree}")
    native.build_many(["seq_step"])
    # load and warm the kernel and the host runtime off the clock
    warm = zipf_symbol_stream(3000, num_symbols=12, num_accounts=200, seed=5)
    SeqSession(SQ.SeqConfig(lanes=16, slots=128, accounts=256,
                            max_fills=16, batch=256)).process_wire(warm)
    values = [dumps_order(m) for m in zipf_symbol_stream(**STREAM)]
    srv, broker = serve_broker("127.0.0.1", 0, InProcessBroker())
    client = TcpBroker(*srv.server_address[:2])
    try:
        provision(client)
        for lo in range(0, len(values), 4096):
            client.produce_batch(TOPIC_IN, [(None, v) for v in
                                            values[lo:lo + 4096]])
        svc = MatchService(broker, engine="seq", compat="fixed", pipeline=2,
                           **SERVE)
        stamp = None
        if hasattr(svc, "_stamp_orders"):
            stamp = [0.0]
            orig = svc._stamp_orders

            def timed(*a, **k):
                t0 = time.perf_counter()
                orig(*a, **k)
                stamp[0] += time.perf_counter() - t0

            svc._stamp_orders = timed
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = svc.run(max_messages=len(values), poll_timeout=0.05)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        spans = dict(svc._ptimer.totals)
        dispatches = svc._session.dispatches
        svc.close()
        lines = list(consume_lines(client, follow=False))
    finally:
        client.close()
        srv.shutdown()
        srv.server_close()
    h = hashlib.sha256()
    for ln in lines:
        h.update(ln.encode() + b"\n")
    if n != len(values) or (len(lines), h.hexdigest()) != B1_MATCHOUT:
        raise RuntimeError(f"{n} messages served, MatchOut {len(lines)} "
                           f"lines sha256 {h.hexdigest()}: not B1's")
    return {"tree": tree, "messages": n, "wall_s": wall,
            "serve_engine_s": spans.get("serve_engine", 0.0),
            "serve_produce_s": spans.get("serve_produce", 0.0),
            "serve_observe_s": spans.get("serve_observe"),
            "rest_s": wall - sum(spans.values()),
            "dispatches": dispatches,
            "stamp_orders_s": None if stamp is None else stamp[0]}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])))
        return 0
    if not argv or any(a.startswith("-") for a in argv):
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree], stdout=subprocess.PIPE,
                           text=True)
        out = r.stdout.strip().splitlines()
        if r.returncode or not out:
            print(f"serve_ab: {tree} failed (exit {r.returncode})",
                  file=sys.stderr)
            rc = 1
            continue
        print(out[-1], flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    print(card.stdout.strip().splitlines()[0] if card.stdout else
          "card: not read")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
