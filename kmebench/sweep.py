"""The knee sweep of an open-loop cell: one run at each rate, each in a
process of its own, and for each the latency by quarter of the window
and the backlog at its close. The highest rate whose backlog does not
grow through the window is the knee; the cell's `rate_per_s` is 0.8 of
it, written into its file by hand.

    python -m kmebench.sweep --workload <cell> --rates <r1,r2,..>
                             --seconds <s> --seed <n>
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from kmebench import spec as S


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmebench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    for i, rate in enumerate(float(r) for r in a.rates.split(",")):
        r = subprocess.run(
            [sys.executable, "-m", "kmebench.run", "--workload", a.workload,
             "--seed", str(a.seed + i), "--seconds", str(a.seconds),
             "--trace", "0", "--rate", str(rate)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            cwd=S.ROOT, timeout=600)
        lines = r.stdout.strip().splitlines()
        res = json.loads(lines[-1]) if lines else {}
        d = res.get("detail", {})
        print(json.dumps({
            "rate": rate, "rc": r.returncode,
            "correct": res.get("correct"),
            "metrics": {k: v["value"] for k, v in
                        res.get("metrics", {}).items()},
            "lat_ms": d.get("lat_ms"),
            "by_quarter": d.get("lat_p50_by_quarter_ms"),
            "outstanding_at_close": d.get("outstanding_at_close"),
            "late_ms": d.get("late_ms")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
