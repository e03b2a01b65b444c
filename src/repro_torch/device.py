"""Device resolution and the float32 precision rule of the port."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "full_fp32"]


def resolve_device(device=None) -> torch.device:
    """`None` means the card.  Without a CUDA device that raises: the
    port never carries on silently on the host; callers that want the
    plain CPU versions pass `device="cpu"` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda")
    return torch.device(device)


def full_fp32() -> None:
    """Pin float32 matrix products to true fp32 (no TF32).

    DCE's exactness in f32 rests on orthogonal keys and true fp32 sums;
    TF32 keeps about three decimal digits and flips comparison signs.
    Both flags are process-wide, so every plain version and the device
    encryptors set them before their products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
