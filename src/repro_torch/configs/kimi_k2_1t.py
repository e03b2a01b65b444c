"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8
(arXiv:2501.kimi2, paper-table config).  61L d_model=7168 64H(kv=8)
d_ff=2048/expert vocab=163840.  ~1.03T total / ~32B active params."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, d_head=112,
    n_experts=384, experts_per_token=8, moe_capacity_factor=1.25,
    fsdp=True,
)
