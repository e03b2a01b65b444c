"""Deterministic, resumable, shardable token pipeline (a copy of
`repro.data.loader`: the same arguments give the same batches, bit for
bit).

Synthetic LM corpus with learnable structure (order-2 Markov chain over the
vocab): loss provably decreases under training, unlike iid tokens.  The
loader state is a plain (step, seed) tuple — checkpoint it and resume
bit-identically on any host; each data shard draws a disjoint substream
(host-sharded input pipeline)."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenStream"]


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    step: int = 0
    markov_temp: float = 0.5       # lower = more predictable corpus

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # sparse row-stochastic transition matrix (8 successors per token)
        self._succ = rng.integers(0, v, size=(v, 8))
        logits = rng.standard_normal((v, 8)) / self.markov_temp
        p = np.exp(logits - logits.max(1, keepdims=True))
        self._p = p / p.sum(1, keepdims=True)

    # ------------------------------------------------------------ state

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed, "shard": self.shard,
                "n_shards": self.n_shards}

    @classmethod
    def from_state(cls, state: dict, **kw) -> "TokenStream":
        return cls(step=state["step"], seed=state["seed"],
                   shard=state["shard"], n_shards=state["n_shards"], **kw)

    # ------------------------------------------------------------ batches

    def _gen(self, rng, n_rows):
        v = self.vocab_size
        toks = np.empty((n_rows, self.seq_len + 1), np.int32)
        cur = rng.integers(0, v, size=n_rows)
        toks[:, 0] = cur
        for t in range(1, self.seq_len + 1):
            u = rng.random(n_rows)
            cum = np.cumsum(self._p[cur], axis=1)
            choice = (u[:, None] < cum).argmax(1)
            cur = self._succ[cur, choice]
            toks[:, t] = cur
        return toks

    def next(self) -> dict:
        """Returns {"tokens", "labels"} for this shard; advances state."""
        assert self.batch_size % self.n_shards == 0
        rows = self.batch_size // self.n_shards
        # disjoint deterministic substream per (step, shard)
        rng = np.random.default_rng(
            (self.seed, self.step, self.shard))
        toks = self._gen(rng, rows)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
