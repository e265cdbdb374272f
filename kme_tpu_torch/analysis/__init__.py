"""kme_tpu_torch.analysis — the port's repo-native static analysis
(`kme-torch-lint`), the port of `kme_tpu/analysis`.

The repo's hardest invariants — replay determinism of the
``(epoch, out_seq)`` stamp stream, byte-exact oracle parity, and a
sync-free pipelined hot loop — are enforced dynamically by tests and
chaos drills, which catch violations only after they ship. This package
checks the same invariants statically over the port's own AST
(`kme_tpu_torch/`), with the JAX package's rule IDs:

  KME-H0xx  hot-path lints: host syncs (torch's `.item()`, `.cpu()`,
            `.numpy()`, `.tolist()`, `.synchronize()`) and blocking I/O
            inside the pipelined submit window (rules.HOT_SCOPES)
  KME-D0xx  determinism lints: wall clock / randomness (torch's RNG
            too) in replay-affecting paths (rules.REPLAY_SCOPES)
  KME-C001  direct clock calls in clock-seamed functions
  KME-E001  clock / RNG in the event-identity path
  KME-T002/3  implicit and width-unstable dtypes in engine/ and ops/
  KME-L0xx  lock discipline: statically extracted lock-order cycles and
            attributes mutated from multiple threads without a common
            lock (lockgraph.py), backed by the KME_LOCKCHECK=1 runtime
            recorder (lockcheck.py)

Rule IDs are stable; a checked-in baseline (LINT_BASELINE_TORCH.json at
the repo root; LINT_BASELINE.json is the JAX package's) grandfathers
existing findings, each with a note that says why it is sound, and
``kme-torch-lint --gate`` exits nonzero only on NEW ones. Fingerprints
hash the rule, file, enclosing scope and normalized source line — not
line numbers — so unrelated edits above a finding do not invalidate the
baseline.

Analysis is additive: nothing here changes runtime behavior.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str        # stable rule id, e.g. "KME-H001"
    path: str        # repo-relative, forward slashes
    line: int        # 1-based
    col: int
    scope: str       # "Class.method", "function", or "<module>"
    message: str
    snippet: str     # stripped source line the finding anchors to

    @property
    def fingerprint(self) -> str:
        """Line-shift-stable identity: rule + file + scope + the
        normalized source line. Duplicate snippets in one scope share a
        fingerprint; the baseline stores per-fingerprint counts so a
        NEW duplicate of a grandfathered line still gates."""
        norm = " ".join(self.snippet.split())
        raw = f"{self.rule}|{self.path}|{self.scope}|{norm}"
        return hashlib.sha256(raw.encode()).hexdigest()[:16]

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.scope}] {self.message}\n    {self.snippet}")


def repo_root(start: Optional[str] = None) -> str:
    """The repo root: nearest ancestor of `start` (default: this
    package) holding pyproject.toml, else the package's parent."""
    here = start or os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    d = os.path.abspath(here)
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))
        d = parent


BASELINE_NAME = "LINT_BASELINE_TORCH.json"


def load_baseline(path: str) -> Dict[str, dict]:
    """fingerprint -> {rule, path, scope, count, note?}. Missing file
    means an empty baseline (everything is new)."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    if data.get("version") != 1:
        raise ValueError(f"unknown baseline version in {path}: "
                         f"{data.get('version')!r}")
    return data.get("findings", {})


def save_baseline(path: str, findings: List[Finding],
                  notes: Optional[Dict[str, str]] = None) -> None:
    """Write the baseline for the given findings, preserving any
    `note` strings already attached to surviving fingerprints."""
    old = {}
    try:
        old = load_baseline(path)
    except (OSError, ValueError):
        pass
    table: Dict[str, dict] = {}
    for f in findings:
        fp = f.fingerprint
        ent = table.setdefault(fp, {
            "rule": f.rule, "path": f.path, "scope": f.scope,
            "snippet": " ".join(f.snippet.split()), "count": 0})
        ent["count"] += 1
        note = (notes or {}).get(fp) or old.get(fp, {}).get("note")
        if note:
            ent["note"] = note
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "findings": table}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def split_new(findings: List[Finding],
              baseline: Dict[str, dict]):
    """Partition findings into (new, grandfathered) against the
    per-fingerprint counts in the baseline."""
    budget = {fp: ent.get("count", 1) for fp, ent in baseline.items()}
    new, known = [], []
    for f in findings:
        fp = f.fingerprint
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            known.append(f)
        else:
            new.append(f)
    return new, known
