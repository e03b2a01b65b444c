"""grok-1-314b [moe] — 8 experts top-2 (hf:xai-org/grok-1).
64L d_model=6144 48H(kv=8) d_ff=32768 vocab=131072.  Experts (8) do not
divide the model axis (16): EP falls back to per-expert TP on d_ff
(see sharding rules)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab_size=131072, d_head=128,
    n_experts=8, experts_per_token=2, moe_capacity_factor=1.25,
    fsdp=True,
)
