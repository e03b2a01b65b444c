"""qwen2.5-14b [dense] — GQA kv=8, QKV bias (hf:Qwen/Qwen2.5).
48L d_model=5120 40H(kv=8) d_ff=13824 vocab=152064."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab_size=152064, d_head=128, qkv_bias=True, rope_theta=1e6,
    fsdp=True,
)
