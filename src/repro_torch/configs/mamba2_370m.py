"""mamba2-370m [ssm] — SSD, attention-free (arXiv:2405.21060).
48L d_model=1024 vocab=50280, ssm_state=128.  Runs long_500k (O(1) decode
state).  vocab 50280 is not mesh-divisible -> embeddings replicate."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, d_head=0,
    ssm_state=128, ssm_expand=2, ssm_conv=4, ssm_head_dim=64, ssm_groups=1,
    tie_embeddings=True,
)
