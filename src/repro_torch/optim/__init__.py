"""Optimizer of the LM trainer: AdamW with global-norm clipping, the
cosine schedule, and int8 error-feedback compression (the port's
``repro.optim``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
