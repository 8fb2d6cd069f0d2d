"""The analyzer's CLI: ``python -m repro_torch.analysis.check [--all | --plans
--smem --schedules] [--json PATH]``.

Runs the passes and exits 1 on any finding, 0 when clean. ``--json``
writes ``Report.to_dict``: {ok, checks: {pass: n}, n_findings, findings}.
Runs on the CPU; nothing launches.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .report import Report

PASSES = ("plans", "smem", "schedules")


def run_passes(names: Sequence[str]) -> Report:
    """Run the named passes; return their Report."""
    report = Report()
    for name in names:
        if name == "plans":
            from .plans import check_plans as fn
        elif name == "smem":
            from .smem import check_smem as fn
        elif name == "schedules":
            from .schedules import check_schedules as fn
        else:
            raise ValueError(f"unknown analysis pass {name!r} (have {', '.join(PASSES)})")
        findings, checks = fn()
        report.add(name, findings, checks)
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="Kernel-contract verification (plan invariants, shared "
                    "memory, schedule partitions).")
    ap.add_argument("--all", action="store_true",
                    help="run every pass (the default when no pass is named)")
    for name in PASSES:
        ap.add_argument(f"--{name}", action="store_true", help=f"run the {name} pass")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the report as JSON to PATH")
    args = ap.parse_args(argv)
    selected = [name for name in PASSES if getattr(args, name)]
    if args.all or not selected:
        selected = list(PASSES)
    report = run_passes(selected)
    print(report.summary())
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(report.to_json())
        print(f"json report: {args.json}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
