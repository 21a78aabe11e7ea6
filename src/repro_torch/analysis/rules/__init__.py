"""Rule registry: the six hot-path contract rules, in ID order."""
from repro_torch.analysis.rules.base import ModuleContext, Rule
from repro_torch.analysis.rules.r001_host_sync import HostSyncRule
from repro_torch.analysis.rules.r002_retrace import RetraceRule
from repro_torch.analysis.rules.r003_protocol import ProtocolRule
from repro_torch.analysis.rules.r004_pallas import PallasRule
from repro_torch.analysis.rules.r005_ledger import LedgerRule
from repro_torch.analysis.rules.r006_telemetry import TelemetryRule


def all_rules(smem_ceiling: int | None = None) -> list[Rule]:
    """Fresh rule instances (PallasRule carries the shared-memory ceiling
    knob)."""
    pallas = PallasRule() if smem_ceiling is None \
        else PallasRule(smem_ceiling)
    return [HostSyncRule(), RetraceRule(), ProtocolRule(), pallas,
            LedgerRule(), TelemetryRule()]


__all__ = ["ModuleContext", "Rule", "HostSyncRule", "RetraceRule",
           "ProtocolRule", "PallasRule", "LedgerRule", "TelemetryRule",
           "all_rules"]
