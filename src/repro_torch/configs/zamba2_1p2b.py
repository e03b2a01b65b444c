"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
(arXiv:2411.15242).  38L d_model=2048 32H(kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  Runs long_500k (sub-quadratic: SSM state + shared-attn KV)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, d_head=64,
    ssm_state=64, ssm_expand=2, ssm_conv=4, ssm_head_dim=64, ssm_groups=1,
    attn_every=6, mlp_type="swiglu", tie_embeddings=True,
)
