"""Whole runs on the CPU, at the widths of `tiny.py`, with the look for a
card skipped and the program's plain PyTorch kernels serving: every cell
comes out correct and loads nothing of JAX; and with the served path
broken underneath, `correct` comes out false for each fault a cell can
have: an answer altered where it is produced, half of a batch's records
left out, a record produced twice, a step that leaves the state as it
was."""

import json
import os

import pytest

from kme_tpu_torch.bridge.service import MatchService
from kme_tpu_torch.engine import seq as SQ
from kmebench import run as R
from kmebench import spec as S
from kmebench.tests.tiny import tiny_bench

SEED = 2**31 + 101
SECONDS = 2.0


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(str(tmp_path_factory.mktemp("bench")))


def _run(bench, cell, trace=False):
    return R.run_cell(bench, cell, SEED, SECONDS, trace, device="cpu")


def test_every_cell_is_correct_on_the_cpu(bench):
    for cell in sorted(bench.cells):
        out = _run(bench, cell)
        assert out["correct"], (cell, out["checks"])
        assert out["failed"] == 0 and out["attempted"] > 0
        assert "setup_s" in out["metrics"]
        assert list(out)[-1] == "checks"
        assert all(c["limit"] == 0 for c in out["checks"].values())
        want = {m["name"] for m in bench.e2e_for(cell)}
        assert set(out["metrics"]) == want, cell
    assert R.forbidden_modules() == []


def test_a_traced_run_reads_the_program_spans(bench):
    cell = next(c for c in sorted(bench.cells)
                if bench.cells[c]["traffic"] == "steady")
    out = _run(bench, cell, trace=True)
    assert out["correct"]
    # the host-side readers find the histograms; the device ones find
    # no device here and stay out of the line
    got = set(out["metrics"])
    assert "ingress.wait_p99_ms.steady" in got
    assert not any(n.startswith("device.") for n in got)


def test_a_cell_added_as_files_runs_correct(bench):
    """A new mix (bursts of 1.5 times the rate every other half second)
    and a new configuration (70% of the trades on one book), added as
    files and entries, run through the same harness."""
    base = bench.base
    with open(os.path.join(base, "traffic", "bursty.json"), "w") as f:
        json.dump({"arrivals": "poisson", "shape": [[0.5, 0.5], [0.5, 1.5]],
                   "tick_ms": 1}, f)
    cfg = json.load(open(os.path.join(base, "configs", "serve-fixed.json")))
    cfg["stream"].update(symbols=8, preamble_symbols=8,
                         symbol_draw={"hot": 0.7})
    with open(os.path.join(base, "configs", "serve-hot.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(base, "cells", "serve-hot.bursty.json"),
              "w") as f:
        json.dump({"config": "serve-hot", "traffic": "bursty", "chips": 1,
                   "why": "a test cell", "params": {"rate_per_s": 300}}, f)
    doc = dict(bench.doc)
    doc["workloads"] = bench.doc["workloads"] + [
        {"name": "serve-hot.bursty", "config": "serve-hot",
         "traffic": "bursty", "chips": 1, "why": "a test cell"}]
    doc["end_to_end"] = [dict(m, workloads=m["workloads"]
                              + ["serve-hot.bursty"])
                         if "serve-fixed.steady" in m.get("workloads", [])
                         else m for m in bench.doc["end_to_end"]]
    path = os.path.join(os.path.dirname(base), "BENCHMARK-hot.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    b = S.Benchmark(path, base)
    out = R.run_cell(b, "serve-hot.bursty", SEED, SECONDS, False,
                     device="cpu")
    assert out["correct"], out["checks"]
    assert abs(out["attempted"] - 300 * SECONDS) < 6 * (300 * SECONDS) ** .5
    assert set(out["metrics"]) == {"answered_100ms_pct", "setup_s"}


def _nth(n):
    """A predicate that is true on its n-th call only (from 1)."""
    box = [0]

    def hit():
        box[0] += 1
        return box[0] == n
    return hit


def test_an_altered_answer_is_not_correct(bench, monkeypatch):
    orig = MatchService._produce_out
    hit = _nth(3000)

    def altered(self, key, value):
        if hit():
            value = value.replace('"aid":', '"aid":1', 1)
        return orig(self, key, value)

    monkeypatch.setattr(MatchService, "_produce_out", altered)
    out = _run(bench, "serve-java-eos.backlog")
    assert not out["correct"]
    assert out["checks"]["records_differing"]["value"] >= 1


def test_a_record_produced_twice_is_not_correct(bench, monkeypatch):
    orig = MatchService._produce_out
    hit = _nth(3000)

    def doubled(self, key, value):
        if hit():
            orig(self, key, value)
        return orig(self, key, value)

    monkeypatch.setattr(MatchService, "_produce_out", doubled)
    out = _run(bench, "serve-java-eos.backlog")
    assert not out["correct"]
    assert out["checks"]["records_differing"]["value"] >= 1


def test_half_a_batch_left_out_is_not_correct(bench, monkeypatch):
    orig = MatchService._produce_buffer
    hit = _nth(8)

    def halved(self, buf, line_off, ordinal=None):
        if hit():
            line_off = line_off[:(len(line_off) + 1) // 2]
        return orig(self, buf, line_off, ordinal)

    monkeypatch.setattr(MatchService, "_produce_buffer", halved)
    out = _run(bench, "serve-fixed.steady")
    assert not out["correct"]
    assert out["checks"]["messages_unanswered"]["value"] > 0


def test_a_step_that_keeps_its_state_is_not_correct(bench, monkeypatch):
    orig = SQ.seq_scan
    hit = _nth(6)

    def stale(cfg, state, stacked):
        if not hit():
            return orig(cfg, state, stacked)
        before = {k: v.clone() for k, v in state.items()}
        outp = orig(cfg, state, stacked)
        for k, v in before.items():
            state[k].copy_(v)
        return outp

    monkeypatch.setattr(SQ, "seq_scan", stale)
    out = _run(bench, "serve-fixed.steady")
    assert not out["correct"]
    assert out["checks"]["records_differing"]["value"] >= 1
