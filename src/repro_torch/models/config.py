"""Model configuration — one dataclass covers every assigned architecture
family (dense / moe / ssm / hybrid / encdec / vlm)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads

    # attention / mlp options
    mlp_type: str = "swiglu"       # swiglu | squared_relu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_fraction: float = 1.0     # chatglm3: 0.5 ("2d rope")
    rope_theta: float = 10_000.0
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_groups: int = 1

    # hybrid (zamba2): shared attention block every `attn_every` ssm layers
    attn_every: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq_len: int = 0           # stub frontend sequence (1500 frames)

    # vlm (paligemma)
    n_vision_tokens: int = 0       # stub frontend patch embeddings

    # numerics / distribution
    dtype: str = "bfloat16"
    fsdp: bool = False             # ZeRO-3 weight sharding over data axis
    remat: bool = True
    scan_layers: bool = True

    # sub-quadratic attention available? (long_500k eligibility)
    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:      # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_decoder(self) -> bool:
        return True                # all assigned archs decode (enc-dec incl.)

    def smoke(self) -> "ModelConfig":
        """A reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, max(1, min(self.n_kv_heads, 2))),
            d_head=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.experts_per_token else 0),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            enc_seq_len=min(self.enc_seq_len, 16) if self.enc_seq_len else 0,
            n_vision_tokens=(min(self.n_vision_tokens, 8)
                             if self.n_vision_tokens else 0),
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            dtype="float32",
            fsdp=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per-arch shape set)."""
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
