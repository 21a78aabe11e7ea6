"""Fault tolerance of the trainer (the port's ``repro.ft``, stdlib only):
preemption at a step boundary and step-time straggler detection."""
from repro_torch.ft.preemption import PreemptionHandler  # noqa: F401
from repro_torch.ft.straggler import StragglerMonitor  # noqa: F401
