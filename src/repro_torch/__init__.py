"""repro_torch — the PyTorch/CUDA port of `repro` for one NVIDIA H100.

Each module mirrors the `repro` module at the same relative path.  The
device work of the main search path runs in hand-written CUDA C++
kernels (`csrc/`, built with nvcc for sm_90a at first use and loaded
with ctypes); every kernel has a plain PyTorch version beside it, which
runs for CPU tensors only.  Entry points run on the card unless the
caller passes `device="cpu"`.

This package imports neither `jax` nor anything of `repro`: what it
shares with the JAX package (wire formats, key generation, the numpy
encryptors) is kept here as a copy, so identical seeds give
bit-identical keys and ciphertexts in both packages.
"""
