"""chatglm3-6b [dense] — RoPE on half the head dims ("2d rope"), GQA kv=2
(arXiv:2406.12793).  28L d_model=4096 32H(kv=2) d_ff=13696 vocab=65024."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=65024, d_head=128, rope_fraction=0.5,
)
