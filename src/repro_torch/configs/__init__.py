"""Assigned-architecture registry: --arch <id> resolves here."""
from importlib import import_module

_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen2.5-14b": "qwen2p5_14b",
    "qwen3-1.7b": "qwen3_1p7b",
    "chatglm3-6b": "chatglm3_6b",
    "nemotron-4-340b": "nemotron4_340b",
    "whisper-small": "whisper_small",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "grok-1-314b": "grok1_314b",
    "mamba2-370m": "mamba2_370m",
    "paligemma-3b": "paligemma_3b",
}

ARCHS = tuple(_MODULES)


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG
