"""nemotron-4-340b [dense] — GQA kv=8, squared-ReLU MLP (arXiv:2402.16819).
96L d_model=18432 96H(kv=8) d_ff=73728 vocab=256000.  ~341B params:
FSDP(ZeRO-3) over data + TP over model is mandatory."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
    vocab_size=256000, d_head=192, mlp_type="squared_relu",
    fsdp=True,
)
