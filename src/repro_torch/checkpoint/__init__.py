"""Checkpoints in the reference's on-disk layout (`repro.checkpoint`)."""

from .ckpt import (  # noqa: F401
    save_checkpoint, restore_checkpoint, latest_step, cleanup_old,
)
