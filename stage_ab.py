"""Time the seq session's H2D staging at pipeline depth 2 for one or more
source trees on one NVIDIA card, in the order given.

    python3 stage_ab.py PARENT . . PARENT    # two trees, alternated

The run is `chip_smoke.py` phase 4's and 3b's pipelined native path: the
zipf stream (109,427 messages) parsed into one WireBatch, cut into
1,024-message batches, and submitted/collected at depth 2 by a fresh
`SeqSession` at full width, B1 (128 slots) and B3 (8192 slots), three
sessions each. Each tree runs in a process of its own, with that tree
first on `sys.path` and its seq kernel built and warmed before the clock
starts. `_Staging.stage` is wrapped with a host-clock timer, whatever
its body is. One JSON line per tree: for every session its construction
seconds, its wall, its `h2d_overlap_frac`, and the first staging's
milliseconds beside the median and the largest of the others. Then the
card's name and power limit. Exits non-zero if any run fails.
"""

import os
import statistics
import sys
import time

import serve_ab

STREAM = dict(num_events=100_000, num_symbols=1024, num_accounts=4096, seed=0,
              payout_per_mille=2)
FULL = dict(lanes=1024, slots=128, accounts=4096, max_fills=16, batch=1024,
            pos_cap=1 << 17, fill_cap=1 << 15, probe_max=64)
DEEP = dict(FULL, slots=8192, hbm_books=True)
SESSIONS = 3


def one(tree: str) -> dict:
    """The pipelined sessions of the package in `tree`."""
    tree = os.path.abspath(tree)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    import torch
    from kme_tpu_torch import native
    from kme_tpu_torch.engine import seq as SQ
    from kme_tpu_torch.runtime import seqsession as SS
    from kme_tpu_torch.wire import WireBatch, dumps_order
    from kme_tpu_torch.workload import zipf_symbol_stream
    import kme_tpu_torch

    if not os.path.abspath(kme_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {kme_tpu_torch.__file__}, not {tree}")
    native.build_many(["seq_step"])
    warm = zipf_symbol_stream(3000, num_symbols=12, num_accounts=200, seed=5)
    SS.SeqSession(SQ.SeqConfig(lanes=16, slots=128, accounts=256,
                               max_fills=16, batch=256)).process_wire(warm)
    buf = "".join(dumps_order(m) + "\n"
                  for m in zipf_symbol_stream(**STREAM)).encode()
    wb = WireBatch.parse_buffer(buf)
    stage_s = []
    orig = SS._Staging.stage

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        r = orig(self, *a, **k)
        stage_s.append(time.perf_counter() - t0)
        return r

    SS._Staging.stage = timed
    runs = []
    for label, kw in (("B1", FULL), ("B3", DEEP)):
        cfg = SQ.SeqConfig(**kw)
        cols = WireBatch._COLS
        batches = [WireBatch(min(cfg.batch, wb.n - lo),
                             [getattr(wb, f)[lo:lo + cfg.batch]
                              for f in cols],
                             wb.hnext[lo:lo + cfg.batch],
                             wb.hprev[lo:lo + cfg.batch])
                   for lo in range(0, wb.n, cfg.batch)]
        for _ in range(SESSIONS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ses = SS.SeqSession(cfg)
            torch.cuda.synchronize()
            made = time.perf_counter() - t
            stage_s.clear()
            pend, n = [], 0
            t = time.perf_counter()
            for b in batches:
                pend.append(ses.submit(b))
                if len(pend) == 2:
                    n += len(ses.collect(pend.pop(0))[0])
            while pend:
                n += len(ses.collect(pend.pop(0))[0])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if ses.dispatches != len(batches) or not n:
                raise RuntimeError(f"{label}: {ses.dispatches} dispatches "
                                   f"for {len(batches)} batches")
            rest = stage_s[1:]
            runs.append({"label": label, "session_s": made, "wall_s": wall,
                         "h2d_overlap_frac": ses.h2d_overlap_frac,
                         "first_stage_ms": stage_s[0] * 1e3,
                         "median_stage_ms": statistics.median(rest) * 1e3,
                         "max_other_stage_ms": max(rest) * 1e3})
            del ses
    return {"tree": tree, "runs": runs}


if __name__ == "__main__":
    sys.exit(serve_ab.main(sys.argv[1:], one, __file__, __doc__))
