"""The LM stack of the dense and VLM families (`repro.models`'s
counterpart); moe, ssm, hybrid and encdec wait for their slices."""

from .config import ModelConfig, ShapeConfig, SHAPES  # noqa: F401
from .model import Model, batch_metas, concrete_batch  # noqa: F401
from . import convert, layers, transformer  # noqa: F401
