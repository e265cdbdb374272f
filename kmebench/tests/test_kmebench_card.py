"""On the card (the `cuda` marker; skipped where there is none): one
short run of each cell through `python -m kmebench.run`, correct, with
the device named in its result."""

import json
import subprocess
import sys

import pytest

from kmebench import spec as S


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(S.Benchmark().cells))
def test_a_short_run_on_the_card(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card only")
    r = subprocess.run([sys.executable, "-m", "kmebench.run", "--workload",
                        cell, "--seed", "7", "--seconds", "3",
                        "--trace", "0"], cwd=S.ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


def test_the_harness_refuses_to_run_without_a_card():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cell = sorted(S.Benchmark().cells)[0]
    r = subprocess.run([sys.executable, "-m", "kmebench.run", "--workload",
                        cell, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=S.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
