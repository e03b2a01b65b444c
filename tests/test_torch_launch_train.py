"""The port's train entry point (`python -m repro_torch.launch.train`) on the
host, and a train step on the card against the host.

This file imports neither JAX nor the JAX package, so its CUDA tests
also run where JAX is not installed:

    python -m pytest -m cuda tests/test_torch_launch_train.py

Tolerances of the card against the host (both the port, float32,
TF32 off): loss rel 1e-5 and gradients max|d| <= 1e-4 * max|g| + 1e-6,
the bars the CPU tests hold the port to against `jax.grad`.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.loader import TokenStream
from repro_torch.device import full_fp32
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.training import (OptConfig, build_train_step,
                                  init_train_state)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, and torch's own thread pool in each would oversubscribe
    them (this file's small ops then spin for minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _run(capsys, argv):
    final, losses = train.main(argv)
    out = capsys.readouterr().out
    return final, losses, out


def test_cli_recovers_from_an_injected_failure_and_resumes(tmp_path,
                                                           capsys):
    ckpt = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--scale", "smoke", "--steps", "30",
            "--batch", "4", "--seq", "32", "--inject-failure-at", "15",
            "--ckpt-dir", ckpt, "--ckpt-every", "10", "--log-every", "5"]
    final, losses, out = _run(capsys, argv)
    assert "recovered from step 10" in out
    assert "restarts=1" in out and "done at step 30" in out
    assert np.isfinite(final) and final < losses[0]
    # the replayed step 10 logs the loss the first pass logged
    tens = re.findall(r"step\s+10 loss (\S+)", out)
    assert len(tens) == 2 and tens[0] == tens[1]

    final2, losses2, out2 = _run(capsys, argv[:-6] + [
        "--steps", "40", "--ckpt-dir", ckpt, "--ckpt-every", "10",
        "--log-every", "5"])
    assert "resumed from step 30" in out2 and "restarts=0" in out2
    assert "done at step 40" in out2 and final2 < losses[0]


def test_cli_refuses_what_the_host_lacks(monkeypatch):
    with pytest.raises(ValueError, match="256 devices"):
        train.main(["--device", "cpu", "--production-mesh", "--steps", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])


def _smoke(arch, device, dtype=torch.float32):
    return Model(get_config(arch).smoke(), device=device, dtype=dtype,
                 seed=0)


def _batch(cfg, device, B=2, S=64):
    rng = np.random.default_rng(0)
    s_text = S - (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    tokens = rng.integers(0, cfg.vocab_size, (B, s_text)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["enc_input"] = rng.standard_normal(
            (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m",
                                  "grok-1-314b", "whisper-small"])
def test_train_step_on_the_card_matches_the_host(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    full_fp32()
    host = _smoke(arch, "cpu")
    card = Model(host.cfg, device="cuda", seed=None)
    card.load_state_dict(host.state_dict())
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    got = {}
    for name, model in (("cpu", host), ("cuda", card)):
        state = init_train_state(model, opt)
        step = build_train_step(model, opt, n_microbatches=2)
        state, m = step(state, _batch(model.cfg, model.device))
        got[name] = (float(m["loss"]), float(m["grad_norm"]),
                     {k: v.cpu() for k, v in state["params"].items()})
    assert got["cuda"][0] == pytest.approx(got["cpu"][0], rel=LOSS_RTOL)
    assert got["cuda"][1] == pytest.approx(got["cpu"][1], rel=1e-4)
    for k, p in got["cpu"][2].items():
        assert torch.isfinite(got["cuda"][2][k]).all(), k
        assert (got["cuda"][2][k] - p).abs().max() <= 2e-3, k


@pytest.mark.cuda
def test_train_loss_decreases_on_the_card_in_bf16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _smoke("qwen3-1.7b", "cuda", torch.bfloat16)
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                    weight_decay=0.0)
    state = init_train_state(model, opt)
    step = build_train_step(model, opt)
    stream = TokenStream(vocab_size=model.cfg.vocab_size, seq_len=32,
                         batch_size=8, markov_temp=0.3)
    losses = []
    for _ in range(40):
        state, m = step(state, stream.next())
        losses.append(float(m["loss"]))
    assert all(p.dtype == torch.bfloat16 for p in state["params"].values())
    assert state["opt"]["m"]["embed.tokens"].dtype == torch.float32
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), losses
