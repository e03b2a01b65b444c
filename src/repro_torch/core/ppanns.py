"""The PP-ANNS scheme's roles (paper §V, Figs. 1 & 3).

  * DataOwner — holds the secret keys; encrypts the database with DCPE
    (filter ciphertexts) and DCE (refine ciphertexts) and builds the HNSW
    graph over C_SAP.  The numpy `encrypt_database` path is the JAX
    package's, bit for bit (ciphertexts and graph); the batched
    `encrypt_vectors` path runs on the card.
  * User — receives the keys from the owner; per query computes the DCPE
    ciphertext C_SAP_q and the DCE trapdoor T_q (O(d^2) work, §V-C) and
    sends (C_SAP_q, T_q, k).
  * Server — runs Algorithm 2 on ciphertexts only: a facade over
    `serving.search_engine.SecureSearchEngine` with the paper's HNSW
    filter (the per-query host walk), the refine on the card.

`Keys` crosses process boundaries (and packages) through the same wire
frame as the JAX package's `Keys` (kind "ppanns-keys", version 1), so
keys round-trip bit for bit in both directions.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.common import next_bucket
from . import dce, dcpe
from . import hnsw as hnsw_mod
from .wireformat import WireFormatError, pack, unpack

__all__ = ["Keys", "KEYS_WIRE_VERSION", "EncryptedDatabase", "DataOwner",
           "User", "Server", "build_system"]

KEYS_WIRE_VERSION = 1


@dataclasses.dataclass
class Keys:
    dce_key: dce.DCEKey
    sap_key: dcpe.SAPKey

    @property
    def d(self) -> int:
        return self.dce_key.d

    # The owner->user key handoff and the on-disk keystore both move keys
    # across a process boundary; this is the only sanctioned format.
    # float64 key matrices round-trip bit-exactly (npz keeps dtypes), so
    # ciphertexts produced before and after a round-trip are identical
    # for the same randomness seed.

    def to_bytes(self) -> bytes:
        k = self.dce_key
        return pack(
            "ppanns-keys", KEYS_WIRE_VERSION,
            arrays={
                "perm1": k.perm1, "perm2": k.perm2,
                "M1": k.M1, "M1_inv": k.M1_inv,
                "M2": k.M2, "M2_inv": k.M2_inv,
                "M3": k.M3, "M3_inv": k.M3_inv,
                "r": k.r, "kv": k.kv,
            },
            meta={"d": k.d, "d_pad": k.d_pad,
                  "sap_s": self.sap_key.s, "sap_beta": self.sap_key.beta})

    @classmethod
    def from_bytes(cls, data: bytes, *, expect_d: int | None = None
                   ) -> "Keys":
        """Deserialize; refuses a mismatched wire version (via `unpack`)
        and, when `expect_d` is given, keys for any other dimension —
        loading d=128 keys into a d=512 collection must fail loudly, not
        produce garbage ciphertexts."""
        arrays, meta = unpack(data, "ppanns-keys", KEYS_WIRE_VERSION)
        d, d_pad = int(meta["d"]), int(meta["d_pad"])
        if expect_d is not None and d != int(expect_d):
            raise WireFormatError(
                f"keys are for d={d}, expected d={int(expect_d)}")
        if d_pad != d + (d % 2):
            raise WireFormatError(f"inconsistent key dims d={d}, "
                                  f"d_pad={d_pad}")
        h, big = d_pad // 2 + 4, 2 * d_pad + 16
        shapes = {"perm1": (d_pad,), "perm2": (d_pad + 8,),
                  "M1": (h, h), "M1_inv": (h, h), "M2": (h, h),
                  "M2_inv": (h, h), "M3": (big, big), "M3_inv": (big, big),
                  "r": (4,), "kv": (4, big)}
        for name, shape in shapes.items():
            got = arrays[name].shape if name in arrays else None
            if got != shape:
                raise WireFormatError(
                    f"key component {name!r}: expected shape {shape} for "
                    f"d={d}, payload has {got}")
        dce_key = dce.DCEKey(d=d, d_pad=d_pad, **{
            name: np.asarray(arrays[name]) for name in shapes})
        sap_key = dcpe.SAPKey(s=float(meta["sap_s"]),
                              beta=float(meta["sap_beta"]))
        return cls(dce_key=dce_key, sap_key=sap_key)


@dataclasses.dataclass
class EncryptedDatabase:
    """Everything the server stores (paper §V-A): C_SAP, the graph index
    over C_SAP, and C_DCE."""
    C_sap: np.ndarray            # (n, d)       DCPE ciphertexts
    index: object | None         # graph index on C_sap (None: no graph)
    C_dce: np.ndarray            # (n, 4, 2d+16) DCE ciphertexts

    @property
    def n(self) -> int:
        return self.C_sap.shape[0]


class DataOwner:
    def __init__(self, d: int, sap_beta: float, sap_s: float = 1024.0,
                 seed: int = 0):
        self.keys = Keys(
            dce_key=dce.keygen(d, seed=seed),
            sap_key=dcpe.keygen(s=sap_s, beta=sap_beta),
        )
        self._seed = seed
        self._enc_ctr = 10_000 + seed    # fresh-randomness counter (ingest)
        self._enc_lock = threading.Lock()

    @classmethod
    def from_keys(cls, keys: Keys, seed: int = 0) -> "DataOwner":
        """Rehydrate an owner around round-tripped keys (`api`).

        `seed` keeps the deterministic `encrypt_database` schedule;
        the fresh-randomness counter for `encrypt_vectors` restarts
        from fresh entropy, NEVER from the seed — a restarted owner
        re-drawing an earlier incarnation's auto-seeds would let the
        server difference old and new ciphertexts."""
        self = cls.__new__(cls)
        self.keys = keys
        self._seed = int(seed)
        self._enc_ctr = 10_000 + int(
            np.random.SeedSequence().entropy % (2 ** 31))
        self._enc_lock = threading.Lock()
        return self

    def encrypt_database(
        self, P: np.ndarray, M: int = 16, ef_construction: int = 200,
        progress_every: int = 0, build_index: bool = True,
    ) -> EncryptedDatabase:
        """The numpy encryption of the whole database and the HNSW graph
        over C_SAP (host numpy), bit-identical to the JAX package's for
        the same seed."""
        P = np.atleast_2d(np.asarray(P))
        C_sap = dcpe.encrypt(P, self.keys.sap_key, seed=self._seed + 1)
        C_dce = dce.encrypt(P, self.keys.dce_key, seed=self._seed + 2)
        index = None
        if build_index:
            index = hnsw_mod.HNSW(dim=P.shape[1], M=M,
                                  ef_construction=ef_construction,
                                  seed=self._seed + 3)
            index.build(C_sap, progress_every=progress_every)
        return EncryptedDatabase(C_sap=C_sap, index=index, C_dce=C_dce)

    def encrypt_vector(self, p: np.ndarray, seed: int):
        """For incremental insert (paper §V-D): owner encrypts, server links."""
        C_sap = dcpe.encrypt(p[None], self.keys.sap_key, seed=seed)[0]
        C_dce = dce.encrypt(p[None], self.keys.dce_key, seed=seed + 1)[0]
        return C_sap, C_dce

    def encrypt_vectors(self, P: np.ndarray, seed: int | None = None,
                        device=None):
        """Batched owner-side encryption on the device (ingestion and
        bulk loads).

        Routes through `dcpe.encrypt_torch` and `dce.encrypt_torch` with
        the batch padded to a power-of-two bucket capped at 4096 (larger
        batches chunk), as the JAX package's owner does.  Each chunk
        draws its noise from a generator seeded from `seed` (or from the
        owner's locked counter), so no two batches share noise.
        `device=None` means the card.
        Returns (C_sap (m, d), C_dce (m, 4, 2d+16)) numpy float32.
        """
        device = resolve_device(device)
        P = np.atleast_2d(np.asarray(P, np.float32))
        m = P.shape[0]
        chunk = 4096
        if m > chunk:
            parts = [self.encrypt_vectors(
                P[i: i + chunk],
                None if seed is None else seed + 7919 * (i // chunk),
                device=device)
                for i in range(0, m, chunk)]
            return (np.concatenate([a for a, _ in parts]),
                    np.concatenate([b for _, b in parts]))
        if seed is None:
            # atomic: concurrent ingestion threads must never share a
            # seed (identical noise across two batches would let the
            # server difference the ciphertexts)
            with self._enc_lock:
                self._enc_ctr += 2
                seed = self._enc_ctr
        bucket = next_bucket(m, minimum=8)
        # pad by replicating real rows, never zeros: DCE's randomization
        # scale is sqrt(mean(hat^2)) over the whole batch, so zero rows
        # would shrink the Eq. 2 blinding noise below the spec strength
        Pp = np.concatenate(
            [P, P[np.arange(bucket - m) % m]], axis=0) \
            if bucket != m else P
        gen_sap = torch.Generator(device=device).manual_seed(seed)
        gen_dce = torch.Generator(device=device).manual_seed(seed + 1)
        C_sap = dcpe.encrypt_torch(Pp, self.keys.sap_key, gen_sap, device)
        C_dce = dce.encrypt_torch(Pp, self.keys.dce_key, gen_dce, device)
        return C_sap[:m].cpu().numpy(), C_dce[:m].cpu().numpy()

    def share_keys(self) -> Keys:
        """Owner -> trusted user key handoff (threat model §II-B)."""
        return self.keys


class User:
    def __init__(self, keys: Keys, seed: int = 17):
        self.keys = keys
        self._ctr = seed

    def encrypt_query(self, q: np.ndarray):
        """-> (C_SAP_q, T_q): the only user-side work per query (O(d^2))."""
        self._ctr += 2
        C_sap_q = dcpe.encrypt(q[None], self.keys.sap_key, seed=self._ctr)[0]
        T_q = dce.trapgen(q[None], self.keys.dce_key, seed=self._ctr + 1)[0]
        return C_sap_q, T_q


class Server:
    """Runs Algorithm 2 on ciphertexts only.

    A thin facade over `SecureSearchEngine` with the paper's HNSW filter
    backend (the per-query host walk): `search` wraps the engine's
    batch-of-one path (so looped `search` and `search_batch` return
    identical ids), and `refine="heap"` keeps the paper's sequential
    max-heap refine with its comparison instrumentation.  `device` is
    where the refine runs (None: the card).
    """

    def __init__(self, db: EncryptedDatabase, device=None):
        from ..serving.search_engine import (HNSWGraphFilter,
                                             SecureSearchEngine)
        self.db = db
        self.engine = SecureSearchEngine(
            db.C_sap, db.C_dce, backend=HNSWGraphFilter(db.index),
            device=device)

    def search(self, C_sap_q: np.ndarray, T_q: np.ndarray, k: int,
               ratio_k: float = 8.0, ef_search: int = 96,
               refine: str = "tournament"):   # | "heap" | "none"
        warnings.warn(
            "ppanns.Server.search is a legacy entry point; new code should "
            "go through repro_torch.api (QueryClient.encrypt_query -> "
            "SecureAnnService.submit), which returns the same ids",
            DeprecationWarning, stacklevel=2)
        return self.engine.search(
            np.asarray(C_sap_q), np.asarray(T_q), k, ratio_k=ratio_k,
            ef_search=ef_search, refine=refine)

    def search_batch(self, Q_sap: np.ndarray, T_q: np.ndarray, k: int,
                     ratio_k: float = 8.0, ef_search: int = 96):
        """Batched Algorithm 2: HNSW filter per query (host graph walk),
        one batched DCE tournament refine on the engine's device."""
        return self.engine.search_batch(
            Q_sap, T_q, k, ratio_k=ratio_k, ef_search=ef_search)

    # ------------------------------------------------- maintenance (§V-D)

    def insert(self, C_sap: np.ndarray, C_dce_vec: np.ndarray):
        node = self.db.index.insert(C_sap)
        self.db.C_sap = np.concatenate([self.db.C_sap, C_sap[None]], 0)
        self.db.C_dce = np.concatenate([self.db.C_dce, C_dce_vec[None]], 0)
        self.engine.update_database(self.db.C_sap, self.db.C_dce)
        return node

    def delete(self, node: int):
        """Deletion needs no data-owner participation (paper §V-D)."""
        self.db.index.delete(node)
        self.db.C_dce[node] = 0.0     # scrub ciphertext
        self.engine.update_database(self.db.C_sap, self.db.C_dce)


def build_system(P: np.ndarray, beta_fraction: float = 0.05,
                 beta: float | None = None, s: float = 1024.0,
                 M: int = 16, ef_construction: int = 200, seed: int = 0,
                 device=None):
    """Convenience: owner encrypts P, returns (owner, user, server).

    .. deprecated:: use `repro_torch.api` — `DataOwnerClient(spec)` +
       `encrypt_corpus` + `SecureAnnService.create_collection` builds the
       same system behind the typed protocol (and serializable keys /
       queries / collections); parity is asserted in
       tests/test_torch_api.py.
    """
    warnings.warn(
        "ppanns.build_system is deprecated; use repro_torch.api "
        "(DataOwnerClient / QueryClient / SecureAnnService)",
        DeprecationWarning, stacklevel=2)
    P = np.atleast_2d(np.asarray(P))
    if beta is None:
        beta = dcpe.suggest_beta(P, fraction=beta_fraction)
    owner = DataOwner(d=P.shape[1], sap_beta=beta, sap_s=s, seed=seed)
    db = owner.encrypt_database(P, M=M, ef_construction=ef_construction)
    user = User(owner.share_keys())
    return owner, user, Server(db, device=device)
