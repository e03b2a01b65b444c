"""paligemma-3b [vlm] — SigLIP frontend STUB: input_specs provides
precomputed (B, 256, 2048) patch embeddings (arXiv:2407.07726); gemma
backbone, MQA kv=1.  18L d_model=2048 8H(kv=1) d_ff=16384 vocab=257216.
Prefix-LM mask: bidirectional over the image prefix, causal after."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=257216, d_head=256, n_vision_tokens=256,
    tie_embeddings=True,
)
