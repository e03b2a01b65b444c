"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block, the
counterpart of `repro.models.ssm` in plain torch ops.

Prefill / forward: chunked SSD — a within-chunk quadratic "attention"
term plus an inter-chunk state recurrence (the reference's `lax.scan`
over chunks is a loop here).  Decode: the O(1) recurrent state update
(B, H, P, N), no KV growth.

Layout: x (B, S, D) -> z, xs (B, S, dI), B/C (B, S, G, N), dt (B, S, H);
depthwise causal conv over [xs, B, C]; heads H = dI / P.  The casts are
the reference's: float32 for dA, the dt-scaled input, B/C, the state,
softplus and silu; the input dtype for the conv sum and for y.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import rms_norm

__all__ = ["ssd_chunked", "mamba_block", "mamba_decode_step", "SSD_CHUNK"]

SSD_CHUNK = 128


def _segsum(dA):
    """dA: (..., q) -> (..., q, q) with out[i, j] = sum_{j < m <= i} dA[m],
    -inf above the diagonal (exp -> lower-triangular decay matrix).  The
    upper triangle is filled before any exp: its differences can be large
    and positive, and exp would overflow them to inf."""
    q = dA.shape[-1]
    csum = torch.cumsum(dA, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=dA.device).tril()
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan.

    xh: (B, S, H, P) head inputs;   dt: (B, S, H) positive step sizes
    A:  (H,) negative decay rates;  Bm, Cm: (B, S, H, N) (head-expanded)
    Returns (y (B, S, H, P) in xh's dtype, final_state (B, H, P, N) f32).

    The reference's three- and four-operand einsums are written as
    two-operand contractions in its operand order, so no (B, nc, q, q,
    H, P) intermediate is built.
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"sequence length {S} must be a multiple of the "
                         f"SSD chunk {chunk} (or at most {chunk})")

    f32 = torch.float32
    dA = (dt * A).to(f32)                                       # (B,S,H)
    xdt = (xh * dt[..., None]).to(f32)                          # dt-scaled in

    def c(t):                  # (B, S, ...) -> (B, nc, chunk, ...)
        return t.reshape((Bsz, nc, chunk) + t.shape[2:])

    dA_c = c(dA).permute(0, 3, 1, 2)                            # (B,H,nc,q)
    x_c, B_c, C_c = c(xdt), c(Bm.to(f32)), c(Cm.to(f32))

    # 1. within-chunk (quadratic) term: C.B over n, times L, then x over k
    Lm = torch.exp(_segsum(dA_c))                               # (B,H,nc,q,q)
    cb = torch.einsum("bcqhn,bckhn->bcqkh", C_c, B_c)
    cb = cb * Lm.permute(0, 2, 3, 4, 1)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", cb, x_c)

    # 2. per-chunk states: B times the decay, then x over k
    dA_cs = torch.cumsum(dA_c, dim=-1)                          # (B,H,nc,q)
    decay_in = torch.exp(dA_cs[..., -1:] - dA_cs)               # (B,H,nc,q)
    bd = B_c * decay_in.permute(0, 2, 3, 1)[..., None]          # (B,c,k,H,N)
    states = torch.einsum("bckhn,bckhp->bchpn", bd, x_c)

    # 3. inter-chunk recurrence
    chunk_decay = torch.exp(dA_cs[..., -1])                     # (B,H,nc)
    state = torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                      # (B,nc,H,P,N)

    # 4. state -> output contribution: C.state over n, times the decay
    out_decay = torch.exp(dA_cs)                                # (B,H,nc,q)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", C_c, prev_states)
    y_off = y_off * out_decay.permute(0, 2, 3, 1)[..., None]

    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y.to(xh.dtype), state


def _split_proj(x, params, cfg: ModelConfig):
    dI = cfg.d_inner
    GN = cfg.ssm_groups * cfg.ssm_state
    z = x @ params["wz"].to(x.dtype)                            # (B,S,dI)
    xs = x @ params["wx"].to(x.dtype)                           # (B,S,dI)
    Bp = x @ params["wb"].to(x.dtype)                           # (B,S,GN)
    Cp = x @ params["wc"].to(x.dtype)                           # (B,S,GN)
    dt = x @ params["wdt"].to(x.dtype)                          # (B,S,H)
    return z, torch.cat([xs, Bp, Cp], dim=-1), dt, dI, GN


def _conv_apply(conv_in, kernel, *, conv_state=None):
    """Depthwise causal conv1d.  conv_in: (B, S, Cd); kernel: (kw, Cd).

    Without a state: left-pad with zeros.  With the (B, kw-1, Cd) state
    (decode): prepend it, and return the last kw-1 rows as the new state.
    The products and their sum stay in the input's dtype; silu is f32.
    Returns (out, new_state or None)."""
    kw = kernel.shape[0]
    if conv_state is None:
        pad = F.pad(conv_in, (0, 0, kw - 1, 0))
        new_state = None
    else:
        pad = torch.cat([conv_state.to(conv_in.dtype), conv_in], dim=1)
        new_state = pad[:, -(kw - 1):, :]
    S = conv_in.shape[1]
    out = pad[:, 0:S, :] * kernel[0][None, None, :]
    for i in range(1, kw):
        out = out + pad[:, i:i + S, :] * kernel[i][None, None, :]
    return F.silu(out.float()).to(conv_in.dtype), new_state


def _heads(cfg: ModelConfig, conv_out, dI, GN):
    B, S, _ = conv_out.shape
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    xs = conv_out[..., :dI].reshape(B, S, H, P)
    Bm = conv_out[..., dI:dI + GN].reshape(B, S, G, N)
    Cm = conv_out[..., dI + GN:].reshape(B, S, G, N)
    rep = H // G                       # jnp.repeat: each group rep times
    return (xs, Bm.repeat_interleave(rep, dim=2),
            Cm.repeat_interleave(rep, dim=2))


def _gate_out(y, z, params, cfg: ModelConfig, dtype):
    y = rms_norm(y * F.silu(z.float()).to(dtype), params["norm_scale"],
                 cfg.norm_eps)
    return y @ params["wo"].to(dtype)


def mamba_block(x, params, cfg: ModelConfig, chunk: int = SSD_CHUNK):
    """Forward / prefill over the whole sequence, from a zero state.
    Returns (y (B,S,D), {"state": (B,H,P,N) f32, "conv": (B,kw-1,Cd)})."""
    z, conv_in, dt, dI, GN = _split_proj(x, params, cfg)
    conv_out, _ = _conv_apply(conv_in, params["conv"])
    xs, Bm, Cm = _heads(cfg, conv_out, dI, GN)
    A = -torch.exp(params["a_log"].float())                     # (H,)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    y, state = ssd_chunked(xs, dt, A, Bm, Cm, chunk)
    y = y + xs * params["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(x.shape[0], x.shape[1], dI)
    out = _gate_out(y, z, params, cfg, x.dtype)
    # the last kw-1 conv inputs, left-padded with zeros when S < kw-1
    kw = params["conv"].shape[0]
    conv_state = F.pad(conv_in, (0, 0, kw - 1, 0))[:, -(kw - 1):, :]
    return out, {"state": state, "conv": conv_state}


def mamba_decode_step(x, params, cfg: ModelConfig, cache):
    """Single-token decode.  x: (B, 1, D); cache: state (B,H,P,N) f32,
    conv (B, kw-1, Cd).  Returns (y (B,1,D), {"state", "conv"}) — new
    tensors; the caller's are read only."""
    z, conv_in, dt, dI, GN = _split_proj(x, params, cfg)
    conv_out, new_conv = _conv_apply(conv_in, params["conv"],
                                     conv_state=cache["conv"])
    xs, Bm, Cm = _heads(cfg, conv_out, dI, GN)                  # S=1
    A = -torch.exp(params["a_log"].float())
    dt = F.softplus(dt.float() + params["dt_bias"].float())[:, 0]  # (B,H)
    xh = xs[:, 0].float()                                       # (B,H,P)
    Bh = Bm[:, 0].float()                                       # (B,H,N)
    Ch = Cm[:, 0].float()
    dA = torch.exp(dt * A)                                      # (B,H)
    state = cache["state"] * dA[..., None, None] + torch.einsum(
        "bhn,bhp->bhpn", Bh, xh * dt[..., None])
    yh = torch.einsum("bhn,bhpn->bhp", Ch, state)
    yh = yh + xh * params["d_skip"].float()[:, None]
    y = yh.reshape(x.shape[0], 1, dI).to(x.dtype)
    return _gate_out(y, z, params, cfg, x.dtype), {"state": state,
                                                   "conv": new_conv}
