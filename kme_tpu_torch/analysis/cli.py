"""`kme-torch-lint` — run the repo-native rules over the port (and ruff,
when present); the port of `kme_tpu/analysis/cli.py` (`kme-lint`).

Exit codes: 0 clean (or all findings grandfathered with --gate);
1 new findings in --gate mode, or any findings without --gate when
--strict is given; 2 usage/internal error.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from typing import List

from kme_tpu_torch.analysis import (BASELINE_NAME, Finding, load_baseline,
                              repo_root, save_baseline, split_new)
from kme_tpu_torch.analysis import lockgraph, rules


def _rule_rel(abspath: str, root: str) -> str:
    """The path the rule scope tables key on: repo-relative when the
    file is inside the repo, else the path from its last `kme_tpu_torch/`
    component (so fixtures in a tmpdir still hit the right scopes)."""
    rel = os.path.relpath(abspath, root).replace(os.sep, "/")
    if not rel.startswith(".."):
        return rel
    ap = abspath.replace(os.sep, "/")
    idx = ap.rfind("/kme_tpu_torch/")
    return ap[idx + 1:] if idx >= 0 else ap.lstrip("/")


def _iter_py_files(root: str, paths: List[str]):
    """Yield (abspath, rule-path) for .py files under kme_tpu_torch/ (or the
    explicit paths given)."""
    if paths:
        for p in paths:
            ap = os.path.abspath(p)
            if os.path.isdir(ap):
                for dirpath, dirnames, filenames in os.walk(ap):
                    dirnames[:] = [d for d in dirnames
                                   if d not in ("_build", "__pycache__")]
                    for fn in sorted(filenames):
                        if fn.endswith(".py"):
                            full = os.path.join(dirpath, fn)
                            yield full, _rule_rel(full, root)
            elif ap.endswith(".py"):
                yield ap, _rule_rel(ap, root)
        return
    pkg = os.path.join(root, "kme_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames
                       if d not in ("_build", "__pycache__")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                yield full, _rule_rel(full, root)


def run_rules(root: str, paths: List[str]) -> List[Finding]:
    findings: List[Finding] = []
    for full, rel in _iter_py_files(root, paths):
        try:
            with open(full, encoding="utf-8") as f:
                src = f.read()
        except OSError as e:
            findings.append(Finding(
                rule="KME-E000", path=rel, line=0, col=0,
                scope="<io>", message=str(e), snippet=""))
            continue
        findings.extend(rules.analyze_file(rel, src))
    # lock-discipline rules always run over the full threaded surface:
    # the graph is only meaningful whole
    if not paths:
        findings.extend(lockgraph.analyze_modules(root))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def run_ruff(root: str) -> int:
    """Run ruff over kme_tpu_torch/ if installed; returns its exit code,
    or 0 with a note when unavailable (the CI lint job installs it)."""
    exe = shutil.which("ruff")
    if exe is None:
        print("kme-torch-lint: ruff not installed; skipping generic lint "
              "(CI runs it)", file=sys.stderr)
        return 0
    proc = subprocess.run([exe, "check", "kme_tpu_torch"], cwd=root)
    return proc.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="kme-torch-lint",
        description="Repo-native static analysis for kme_tpu_torch.")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: kme_tpu_torch/; "
                         "lock rules only run on the default set)")
    ap.add_argument("--gate", action="store_true",
                    help="fail only on findings not in the baseline")
    ap.add_argument("--strict", action="store_true",
                    help="fail on ANY finding, ignoring the baseline")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline path (default: <root>/"
                         f"{BASELINE_NAME})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record current findings as the baseline")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON on stdout")
    ap.add_argument("--report", default=None,
                    help="also write the report to this file")
    ap.add_argument("--no-ruff", action="store_true",
                    help="skip the ruff pass")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, desc in sorted(rules.RULES.items()):
            print(f"{rid}  {desc}")
        return 0

    root = repo_root()
    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    findings = run_rules(root, args.paths)

    if args.write_baseline:
        save_baseline(baseline_path, findings)
        print(f"kme-torch-lint: wrote {len(findings)} finding(s) to "
              f"{baseline_path}")
        return 0

    baseline = {}
    if args.gate and not args.strict:
        try:
            baseline = load_baseline(baseline_path)
        except ValueError as e:
            print(f"kme-torch-lint: {e}", file=sys.stderr)
            return 2
    new, known = split_new(findings, baseline)
    shown = new if (args.gate and not args.strict) else findings

    lines = [f.render() for f in shown]
    if args.as_json:
        out = json.dumps(
            [{**f.__dict__, "fingerprint": f.fingerprint}
             for f in shown], indent=1)
        print(out)
    else:
        for ln in lines:
            print(ln)
    summary = (f"kme-torch-lint: {len(findings)} finding(s)"
               + (f", {len(known)} grandfathered, {len(new)} new"
                  if args.gate and not args.strict else ""))
    print(summary)
    if args.report:
        with open(args.report, "w") as f:
            f.write("\n".join(lines + [summary]) + "\n")

    rc = 0
    if not args.no_ruff and not args.paths:
        rc = run_ruff(root)
    if args.strict and findings:
        return 1
    if args.gate and new:
        return 1
    return rc if rc == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
