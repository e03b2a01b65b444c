"""Training, the counterpart of `repro.training`: optimizers and the
train step."""

from .optimizer import OptConfig, make_optimizer, cosine_schedule  # noqa: F401
from .train_loop import (build_train_step, init_train_state,  # noqa: F401
                         abstract_train_state, train_state_pspecs)
