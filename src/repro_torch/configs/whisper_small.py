"""whisper-small [audio enc-dec] — conv frontend STUB: input_specs provides
precomputed (B, 1500, 768) frame embeddings (arXiv:2212.04356).
12L enc + 12L dec, d_model=768 12H(kv=12) d_ff=3072 vocab=51865.
Simplifications noted in DESIGN.md: sinusoidal (not learned) decoder
positions; pre-LN layernorm blocks."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, d_head=64, mlp_type="gelu",
    norm_type="layernorm", enc_seq_len=1500, tie_embeddings=True,
)
