"""GSL-LPA engine in PyTorch: pluggable backends behind one ``fit`` call.

Public surface:

  * :class:`Engine` / :class:`EngineConfig` / :class:`DetectionResult`
  * ``register_backend`` / ``backend_names`` / ``choose_backend``
  * ``GLOBAL_CACHE`` / ``PLAN_LOG`` — plan-cache observability
"""
from repro_torch.engine.cache import (  # noqa: F401
    GLOBAL_CACHE,
    PLAN_LOG,
    PlanCache,
    PlanLog,
)
from repro_torch.engine.config import DetectionResult, EngineConfig  # noqa: F401
from repro_torch.engine.engine import Engine, resolve_device  # noqa: F401
from repro_torch.engine.registry import (  # noqa: F401
    backend_names,
    choose_backend,
    get_backend,
    register_backend,
)
