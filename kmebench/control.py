"""The control of the comparison that decides `correct`: the reference
put in the program's place with one guarantee of the configuration
broken (the configuration's `"control"`), judged by the same comparison.
It has to come out not correct.

- `serve-fixed` breaks its fixed-compat semantics: the reference in
  java compat (KProcessor's quirks kept) stands in for the fixed engine.
- `serve-java-eos` breaks the java-exact semantics: the reference in
  fixed compat (the quirks corrected) stands in for KProcessor's.

    python -m kmebench.control --workload <cell> --messages <n>
                               --seeds <a,b,c>

For each seed it makes the cell's stream of n messages (a run's count:
preamble, warm prefix and window), runs the reference and the control,
and prints the numbers the run compares, beside their limits. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np

from kmebench import measure as M
from kmebench import spec as S
from kmebench.reference.native import ReferenceDeath, replay
from kmebench.streams import MessageStream


def control_kw(config: dict) -> dict:
    c = config["control"]
    kw = {"compat": c["compat"]}
    for k in ("book_slots", "max_fills"):
        if k in c:
            kw[k] = c[k]
    return kw


def readings(config: dict, seed: int, n: int) -> Dict[str, int]:
    """The compared numbers of the control standing in for the program
    on the first n messages of the seed's stream."""
    cols = MessageStream(config["stream"], seed).take(n)
    want, counts = replay(cols, **config["reference"])
    try:
        got, _ = replay(cols, **control_kw(config))
    except ReferenceDeath as e:
        got = []
        print(f"control: {e}", file=sys.stderr)
    g, w = M.digests(got), M.digests(want)
    closes = sum(1 for r in got if r.startswith(b"OUT ")
                 and r[14:16] not in (b"5,", b"6,"))
    return {"records_differing": M.records_differing(g, w),
            "messages_unanswered": max(0, n - closes),
            "messages_wrong": M.messages_wrong(g, w, counts),
            "first_difference": M.first_difference(g, w)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmebench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--messages", type=int, required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    config = S.Benchmark().cell(a.workload)["config"]
    for seed in (int(s) for s in a.seeds.split(",")):
        r = readings(config, seed, a.messages)
        r = {k: (int(v) if isinstance(v, (int, np.integer)) else v)
             for k, v in r.items()}
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "messages": a.messages, "control": r,
                          "limit": 0, "correct": r["records_differing"]
                          == 0 and r["messages_unanswered"] == 0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
