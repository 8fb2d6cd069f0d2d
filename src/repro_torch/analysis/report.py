"""Finding and Report, shared by every analysis pass (the reference's
``analysis/report.py``).

A pass returns ``(findings, checks)``: the contract violations it proved,
and the number of facts it verified, so that a pass that silently checks
nothing cannot pass for clean (the CLI prints the counts and the tests
hold them above a floor).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List


@dataclasses.dataclass(frozen=True)
class Finding:
    """One proven contract violation."""
    pass_name: str    # "plans" | "smem" | "schedules"
    check: str        # short id, e.g. "tile-purity"
    location: str     # where: a case name, a kernel instance, a shape
    detail: str       # what failed and why it matters

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"[{self.pass_name}/{self.check}] {self.location}: {self.detail}"


@dataclasses.dataclass
class Report:
    """The passes one CLI or library call ran, together."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    checks: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, pass_name: str, findings: List[Finding], checks: int) -> None:
        self.findings.extend(findings)
        self.checks[pass_name] = self.checks.get(pass_name, 0) + checks

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> Dict:
        return {"ok": self.ok, "checks": dict(self.checks),
                "n_findings": len(self.findings),
                "findings": [f.to_dict() for f in self.findings]}

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def summary(self) -> str:
        lines = []
        for name in sorted(self.checks):
            n_bad = sum(1 for f in self.findings if f.pass_name == name)
            status = "OK" if n_bad == 0 else f"{n_bad} finding(s)"
            lines.append(f"  {name:<10} {self.checks[name]:>7} checks  {status}")
        lines.extend(f"  {f}" for f in self.findings)
        verdict = "CLEAN" if self.ok else f"{len(self.findings)} FINDING(S)"
        lines.append(f"analysis: {verdict} ({sum(self.checks.values())} facts verified)")
        return "\n".join(lines)
