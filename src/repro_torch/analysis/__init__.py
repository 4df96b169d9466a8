"""Static verification of ReduceSchedules and of the hops that ran them.

Counterpart of ``repro/analysis``, with its finding type and its JSON
summary (schema ``repro/analysis/v1``), so the two packages' summaries
compare byte for byte.  Three layers:

``verify``       rule engine over :class:`repro_torch.core.schedule
                 .ReduceSchedule` objects (rules ``SV000``–``SV009``,
                 the reference's messages and locations).
``hop_lint``     the reference's collective lint (rules ``HL001``–
                 ``HL005``) on a **hop log** — the hops a step actually
                 sent, as the transport recorded them — in place of
                 compiled HLO, with the warning baseline.
``import_lint``  AST lint of the port's import rule: no ``jax`` (rule
                 ``IL001``) and nothing of the reference package
                 ``repro`` (``IL002``).

CLI: ``python -m repro_torch.analysis [--source] [--schedules]
[--check-baseline] [--schedule-json FILE] [--json OUT]``; it exits
non-zero on any error.
"""
from __future__ import annotations

import dataclasses

ERROR = "error"
WARN = "warn"
SEVERITIES = (ERROR, WARN)


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of one rule at one location."""
    rule_id: str       # "SV001", "HL002", "IL001", ...
    severity: str      # ERROR | WARN
    location: str      # "bucket[3].stage[1]", "src/x.py:17", "" = global
    message: str
    context: str = ""  # what was being checked (cell label, file, ...)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in "
                             f"{SEVERITIES}")

    def to_json(self) -> dict:
        return {"rule_id": self.rule_id, "severity": self.severity,
                "location": self.location, "message": self.message,
                "context": self.context}

    def render(self) -> str:
        where = ":".join(p for p in (self.context, self.location) if p)
        return f"{self.severity} {self.rule_id} [{where}] {self.message}"


def errors(diags) -> list[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def warnings(diags) -> list[Diagnostic]:
    return [d for d in diags if d.severity == WARN]


def summarize(diags, extra: dict | None = None) -> dict:
    """The JSON summary the dry run records and the CLI writes."""
    out = {
        "schema": "repro/analysis/v1",
        "n_errors": len(errors(diags)),
        "n_warnings": len(warnings(diags)),
        "diagnostics": [d.to_json() for d in diags],
    }
    if extra:
        out.update(extra)
    return out


from . import hop_lint, import_lint, verify  # noqa: E402  (re-exports)

__all__ = ["Diagnostic", "ERROR", "WARN", "SEVERITIES", "errors",
           "warnings", "summarize", "verify", "hop_lint", "import_lint"]
