"""Lint CLI: the hot-path contract rules over src/repro_torch (or any
paths).

    PYTHONPATH=src python -m repro_torch.launch.lint               # report
    PYTHONPATH=src python -m repro_torch.launch.lint --strict      # CI gate
    PYTHONPATH=src python -m repro_torch.launch.lint --json
    PYTHONPATH=src python -m repro_torch.launch.lint --list-rules
    PYTHONPATH=src python -m repro_torch.launch.lint path/to/fixtures/lint
    PYTHONPATH=src python -m repro_torch.launch.lint --write-baseline

Exit codes: 0 clean (or every finding baselined / suppressed), 1 on
actionable findings, 2 on usage errors.  ``--strict`` is the CI gate: it
fails on any finding that is neither inline-suppressed
(``# lint: <tag>-ok — why``) nor in the committed baseline
(``src/repro_torch/analysis/baseline.json``).  Stdlib only: it needs no
``torch`` and no GPU toolchain.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.lint",
        description="PyTorch-port hot-path lint (R001-R006)")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to lint (default: the repro_torch "
                         "package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any non-baselined, non-suppressed "
                         "finding (the CI gate)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline JSON (default: "
                         "src/repro_torch/analysis/baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule IDs to run (e.g. R001,R004)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print findings silenced by inline "
                         "`# lint: <tag>-ok` comments")
    ap.add_argument("--smem-ceiling", type=int, default=None,
                    help="R004 shared-memory bytes of one warp's widest "
                         "row (default 227 KiB, the H100's opt-in per "
                         "block)")
    args = ap.parse_args(argv)

    import repro_torch
    from repro_torch.analysis import Baseline, all_rules, lint_paths

    rules = all_rules(smem_ceiling=args.smem_ceiling)
    if args.list_rules:
        for r in rules:
            print(f"{r.id}  [{r.tag}]  {r.description}")
        return 0
    if args.rules:
        wanted = {r.strip().upper() for r in args.rules.split(",")}
        unknown = wanted - {r.id for r in rules}
        if unknown:
            print(f"unknown rule ids: {sorted(unknown)}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in wanted]

    pkg_root = Path(repro_torch.__file__).parent
    paths = args.paths or [pkg_root]
    baseline_path = args.baseline or pkg_root / "analysis" / "baseline.json"

    findings = lint_paths(paths, rules)
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]

    if args.write_baseline:
        n = Baseline.dump(active, baseline_path)
        print(f"wrote {n} baseline entries to {baseline_path}")
        return 0

    baseline = Baseline.load(baseline_path) if baseline_path.exists() \
        else Baseline()
    new = [f for f in active if f not in baseline]
    known = [f for f in active if f in baseline]

    if args.as_json:
        json.dump({
            "findings": [f.to_json() for f in active],
            "suppressed": [f.to_json() for f in suppressed],
            "baselined": len(known),
            "new": len(new),
        }, sys.stdout, indent=2)
        print()
    else:
        for f in new:
            print(f.format())
        if known:
            print(f"# {len(known)} baselined finding(s) not shown "
                  f"(see {baseline_path})")
        if args.show_suppressed and suppressed:
            print("# inline-suppressed:")
            for f in suppressed:
                print(f"#   {f.format()}")
        if not new:
            print(f"clean: {len(active)} active finding(s), "
                  f"{len(known)} baselined, {len(suppressed)} suppressed")

    if args.strict:
        return 1 if new else 0
    return 0   # report-only by default; CI passes --strict


if __name__ == "__main__":
    sys.exit(main())
