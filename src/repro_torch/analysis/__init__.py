"""repro_torch.analysis — static lint + runtime plan audit for the port's
hot-path contracts (one plan per bucket, no hidden host syncs, backend
protocol conformance, kernel-launch hygiene, ledger discipline,
telemetry at stage boundaries).

The linter half (``findings``, ``lint``, ``rules``) is stdlib only:
importing this package imports no ``torch``.  The audit half
(``trace_audit``, ``workload``) imports the engine, and with it
``torch``, on first access of its names.

CLI: ``python -m repro_torch.launch.lint`` (see README "Static analysis &
plan auditing").
"""
from repro_torch.analysis.findings import Baseline, Finding
from repro_torch.analysis.lint import lint_paths, lint_source, rule_relpath
from repro_torch.analysis.rules import all_rules

__all__ = [
    "Baseline", "Finding", "lint_paths", "lint_source", "rule_relpath",
    "all_rules", "TraceAudit", "ExcessRetraceError", "audit_workload",
    "run_workload",
]

_LAZY = {"TraceAudit": "trace_audit", "ExcessRetraceError": "trace_audit",
         "audit_workload": "workload", "run_workload": "workload"}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
