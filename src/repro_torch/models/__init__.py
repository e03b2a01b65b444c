"""The LM stack of every family (`repro.models`'s counterpart): dense,
moe, vlm, ssm, hybrid and encdec."""

from .config import ModelConfig, ShapeConfig, SHAPES  # noqa: F401
from .model import Model, batch_metas, concrete_batch  # noqa: F401
from . import convert, layers, moe, ssm, transformer  # noqa: F401
