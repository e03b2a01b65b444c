"""DEPRECATED — the legacy sharded server, a shim over the unified
sharded execution layer (DESIGN.md §10), the counterpart of
`repro.serving.ann_server`.

`DistributedSecureANN` predates placement-aware collections.  The real
thing lives in `serving/sharded.py` (`ShardedBackend` behind
`SecureSearchEngine`), which is what `repro_torch.api`'s
`placement=PlacementSpec(kind="sharded")` collections run.  This class
remains only so old callers keep working — it warns, builds the same
sharded backend, and returns the same ids.  Where the JAX package's
class takes a mesh, this one takes the placement devices
(`launch.mesh.local_devices`).
"""

from __future__ import annotations

import warnings

import numpy as np

from ..core import dce
from .runtime.ingest import MutableEncryptedStore
from .search_engine import SecureSearchEngine
from .sharded import ShardedBackend

__all__ = ["DistributedSecureANN"]


class DistributedSecureANN:
    """DEPRECATED shim: sharded filter + batched refine via the unified
    engine.  Use `repro_torch.api` with a sharded `PlacementSpec`
    instead.  `devices`: the placement devices (None: one shard);
    `device`: where the engine runs (None: the card, "cpu": the host)."""

    def __init__(self, C_sap: np.ndarray, C_dce: np.ndarray,
                 devices=None, axis: str = "data", device=None):
        warnings.warn(
            "serving.ann_server.DistributedSecureANN is deprecated; use "
            "repro_torch.api: SecureAnnService.create_collection(spec, "
            "placement=PlacementSpec(kind='sharded', ...)) runs the same "
            "sharded pipeline behind submit()", DeprecationWarning,
            stacklevel=2)
        C_sap = np.asarray(C_sap, np.float32)
        C_dce = np.asarray(C_dce, np.float32)
        self.n = C_sap.shape[0]
        self.devices = devices
        n_shards = 1 if devices is None else len(devices)
        store = MutableEncryptedStore(C_sap.shape[1],
                                      dce.ciphertext_dim(C_sap.shape[1]))
        store.append(C_sap, C_dce)
        self._backend = ShardedBackend(store, "flat", n_shards=n_shards,
                                       data_axis=axis, device=device)
        self._engine = SecureSearchEngine(
            store.sap_view, store.dce_padded_view, backend=self._backend,
            device=device)

    @property
    def n_padded(self) -> int:
        return self._backend.padded_rows

    def query_batch(self, Q_sap: np.ndarray, T_q: np.ndarray, k: int,
                    ratio_k: float = 8.0):
        """Q_sap: (nq, d) DCPE-encrypted queries; T_q: (nq, 2d+16) DCE
        trapdoors.  Returns ids (nq, k); -1 fills slots where fewer than
        k real rows exist — the engine's uniform contract."""
        ids, _ = self._engine.search_batch(Q_sap, T_q, k, ratio_k=ratio_k)
        return ids
