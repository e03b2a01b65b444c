"""The sharded secure-scan step of the port
(`repro_torch.serving.secure_scan`) and the deprecated sharded shims
(`api.mesh.DistributedSecureAnnService`,
`serving.ann_server.DistributedSecureANN`), on the CPU, in port form of
tests/test_secure_scan.py (deep1m stand-in, n 1,200, d 96).

Held exactly: the sharded step (the fused scan per shard, the merge, the
fused refine) at 1, 2 and 4 logical devices returns the global step's
candidates and ids; both return the JAX package's step ids on the same
ciphertexts; the shims warn and return the sharded collection's ids.
Recall@10 >= 0.9 as in the JAX package's test; bf16 ciphertexts keep
>= 97% of the f32 candidate sets.
"""

import jax
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_mesh
from repro.serving import secure_scan as jscan
from repro_torch import api
from repro_torch.api import (DistributedSecureAnnService, EncryptedCorpus,
                             EncryptedQuery, IndexSpec, PlacementSpec,
                             SearchParams, SearchRequest, SecureAnnService)
from repro_torch.core import dce, dcpe, ppanns
from repro_torch.data import synth
from repro_torch.launch.mesh import force_device_count, local_devices
from repro_torch.serving import secure_scan
from repro_torch.serving.ann_server import DistributedSecureANN

CPU = "cpu"
K, KP = 10, 64


@pytest.fixture(autouse=True)
def _eight_logical_devices():
    force_device_count(8)
    yield
    force_device_count(None)


@pytest.fixture(scope="module")
def setup():
    n, nq, seed = 1200, 8, 11
    ds = synth.make_dataset("deep1m", n=n, n_queries=nq, k_gt=20,
                            seed=seed)
    owner = ppanns.DataOwner(d=ds.d, sap_beta=0.5, seed=seed)
    C_sap = dcpe.encrypt(ds.base, owner.keys.sap_key, seed=seed + 1)
    C_dce = dce.encrypt(ds.base, owner.keys.dce_key, seed=seed + 2)
    user = ppanns.User(owner.share_keys())
    qs, ts = zip(*(user.encrypt_query(q) for q in ds.queries))
    return ds, C_sap, C_dce, np.stack(qs), np.stack(ts)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in arrays]


@pytest.fixture(scope="module")
def jax_ids(setup):
    """The JAX package's step on a one-device mesh (its test's setting)."""
    _, C_sap, C_dce, Q, T = setup
    mesh = make_mesh((1,), ("data",))
    step = jscan.build_secure_scan_step(mesh, k=K, k_prime=KP)
    return np.asarray(jax.jit(step)(C_sap, C_dce, Q, T))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_step_matches_gspmd_step(setup, jax_ids, n_shards):
    """Both formulations compute the same candidates and the same exact
    answer, and the JAX package's."""
    _, C_sap, C_dce, Q, T = setup
    devices = local_devices(CPU)[:n_shards]
    a = secure_scan.build_secure_scan_step(devices, k=K, k_prime=KP)
    b = secure_scan.build_secure_scan_step_gspmd(devices, k=K, k_prime=KP)
    ids_a, cand_a = a(*_t(C_sap, C_dce, Q, T), with_candidates=True)
    ids_b, cand_b = b(*_t(C_sap, C_dce, Q, T), with_candidates=True)
    np.testing.assert_array_equal(cand_a.numpy(), cand_b.numpy())
    np.testing.assert_array_equal(ids_a.numpy(), ids_b.numpy())
    np.testing.assert_array_equal(ids_a.numpy(), jax_ids)
    # per-shard blocks in, same answer out
    blocks = list(torch.from_numpy(C_sap).chunk(n_shards))
    ids_c = a(blocks, *_t(C_dce, Q, T))
    np.testing.assert_array_equal(ids_c.numpy(), ids_a.numpy())


def test_scan_step_recall(setup):
    ds, C_sap, C_dce, Q, T = setup
    step = secure_scan.build_secure_scan_step(local_devices(CPU)[:4], k=K,
                                              k_prime=KP)
    ids = step(*_t(C_sap, C_dce, Q, T)).numpy()
    rec = synth.recall_at_k(ids, ds.gt, 10)
    assert rec >= 0.9, rec


def test_step_refuses_an_uneven_split(setup):
    _, C_sap, C_dce, Q, T = setup
    step = secure_scan.build_secure_scan_step(local_devices(CPU)[:7], k=K,
                                              k_prime=KP)
    with pytest.raises(ValueError, match="equal shards"):
        step(*_t(C_sap, C_dce, Q, T))


def test_input_specs_and_pspecs():
    specs = secure_scan.secure_scan_input_specs(4096, 128, 32)
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        "C_sap": (4096, 128), "C_dce": (4096, 4, 272),
        "Q_sap": (32, 128), "T_q": (32, 272)}
    assert all(v.device.type == "meta" for v in specs.values())
    jspecs = jscan.secure_scan_input_specs(4096, 128, 32)
    assert {k: tuple(v.shape) for k, v in jspecs.items()} == \
        {k: tuple(v.shape) for k, v in specs.items()}
    assert secure_scan.secure_scan_pspecs(local_devices(CPU)) == {
        "C_sap": 0, "C_dce": 0, "Q_sap": None, "T_q": None}
    # the public surface re-exports the builders
    assert api.build_secure_scan_step is secure_scan.build_secure_scan_step
    assert api.secure_scan_pspecs is secure_scan.secure_scan_pspecs


def test_bf16_filter_preserves_recall(setup):
    """bf16 quantization of DCPE ciphertexts is ~1e-3 of the SAP
    perturbation radius — candidate sets stay."""
    _, C_sap, _, Q, _ = setup

    def cands(Cm, Qm):
        d = ((Cm[None] - Qm[:, None]) ** 2).sum(-1)
        return [set(r.tolist()) for r in np.argsort(d, axis=1)[:, :KP]]

    c32 = cands(C_sap.astype(np.float32), Q.astype(np.float32))
    bf = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
          for a in (C_sap, Q)]
    c16 = cands(*bf)
    overlap = np.mean([len(a & b) / KP for a, b in zip(c32, c16)])
    assert overlap >= 0.97, overlap


@pytest.mark.parametrize("n_shards", [1, 4])
def test_deprecated_shims_match_the_sharded_collection(setup, n_shards):
    _, C_sap, C_dce, Q, T = setup
    devices = local_devices(CPU)[:n_shards]
    spec = IndexSpec(tenant="t", name="c", d=C_sap.shape[1],
                     backend="flat", seed=0)
    with SecureAnnService(device=CPU) as svc:
        svc.create_collection(spec, EncryptedCorpus(C_sap=C_sap,
                                                    C_dce=C_dce),
                              placement=PlacementSpec(kind="sharded",
                                                      n_shards=n_shards))
        want = svc.submit(SearchRequest(
            tenant="t", collection="c", query=EncryptedQuery(C_sap=Q, T=T),
            params=SearchParams(k=K), coalesce=False)).ids
    with pytest.warns(DeprecationWarning, match="repro_torch.api"):
        shim = DistributedSecureAnnService(C_sap, C_dce, devices=devices,
                                           device=CPU)
    with shim:
        assert shim.n == C_sap.shape[0]
        got = shim.search(EncryptedQuery(C_sap=Q, T=T),
                          SearchParams(k=K)).ids
    np.testing.assert_array_equal(got, want)
    with pytest.warns(DeprecationWarning, match="repro_torch.api"):
        server = DistributedSecureANN(C_sap, C_dce, devices=devices,
                                      device=CPU)
    assert server.n_padded % n_shards == 0
    np.testing.assert_array_equal(server.query_batch(Q, T, K), want)
