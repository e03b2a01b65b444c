"""LM serving engine: batched prefill + greedy/temperature decode with a
KV cache, the counterpart of `repro.serving.engine`.

The reference jits its prefill and decode step; the port runs them
eagerly under `torch.inference_mode()` on the model's device.
"""

from __future__ import annotations

import torch

from ..models.model import Model

__all__ = ["LMServer", "greedy"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, ties to the first index (as
    `jnp.argmax` breaks them; with bf16 logits over a large vocabulary
    ties occur)."""
    top = logits.amax(dim=-1, keepdim=True)
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(logits == top, idx, logits.shape[-1]).amin(dim=-1)


class LMServer:
    def __init__(self, model: Model):
        self.model = model

    @torch.inference_mode()
    def generate(self, batch: dict, max_new_tokens: int,
                 temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """batch: {'tokens': (B, S), ...frontend stubs}.  Greedy when
        temperature == 0.  Returns (B, max_new_tokens) int32 on the
        model's device.

        Temperature sampling draws from `generator` (on the model's
        device) with `torch.multinomial` over softmax(logits / T) in
        float32: the same distribution as the reference's
        `jax.random.categorical`, not the same draws."""
        model = self.model
        B, S = batch["tokens"].shape
        t_max = S + max_new_tokens + (
            model.cfg.n_vision_tokens if model.cfg.family == "vlm" else 0)
        cache = model.init_cache(B, t_max)
        logits, cache = model.prefill(batch, cache)

        out = []
        for i in range(max_new_tokens):
            if temperature > 0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = greedy(logits)
            nxt = nxt.to(torch.int32)[:, None]
            out.append(nxt)
            if i + 1 < max_new_tokens:
                logits, cache = model.decode_step(nxt, cache)
        return torch.cat(out, dim=1)
