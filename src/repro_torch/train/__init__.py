"""Step builders of the LM trainer (the port's ``repro.train``)."""
from repro_torch.train.steps import (  # noqa: F401
    abstract_opt_state,
    init_opt_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
