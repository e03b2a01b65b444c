"""The AME and LSH baselines (`repro_torch.core.{ame,lsh}`, numpy copies)
and the paper's dataset configs (`repro_torch.configs.ppanns_datasets`)
against `repro`'s, on the same seeds: tests/test_ame.py and the LSH case
of tests/test_ann_indexes.py in port form.  Everything is host numpy, so
keys, ciphertexts, comparison values and candidate sets are equal bit
for bit."""

import dataclasses

import numpy as np
import pytest

from repro.configs import ppanns_datasets as jdatasets
from repro.core import ame as jame
from repro.core import lsh as jlsh
from repro_torch.configs import ppanns_datasets as datasets
from repro_torch.core import ame, dce
from repro_torch.core.lsh import LSHIndex
from repro_torch.data import synth


@pytest.mark.parametrize("d", [4, 16, 100])
def test_ame_equals_the_reference_and_its_signs_are_exact(d):
    rng = np.random.default_rng(d)
    P = rng.standard_normal((24, d))
    Q = rng.standard_normal((2, d))
    key, jkey = ame.keygen(d, seed=d), jame.keygen(d, seed=d)
    for f in ("Ma", "Ma_inv", "Mb", "Mb_inv"):
        assert np.array_equal(getattr(key, f), getattr(jkey, f))
    U, V = ame.encrypt(P, key, dtype=np.float64)
    jU, jV = jame.encrypt(P, jkey, dtype=np.float64)
    W, jW = (ame.trapgen(Q, key, dtype=np.float64),
             jame.trapgen(Q, jkey, dtype=np.float64))
    assert np.array_equal(U, jU) and np.array_equal(V, jV)
    assert np.array_equal(W, jW)
    for qi in range(2):
        Z = ame.compare(U[:, None], V[None, :], W[qi])
        assert np.array_equal(Z, jame.compare(jU[:, None], jV[None, :],
                                              jW[qi]))
        dist = ((P - Q[qi]) ** 2).sum(-1)
        true = dist[:, None] - dist[None, :]
        ok = (np.sign(Z) == np.sign(true)) | (np.abs(true) < 1e-8)
        assert ok.all()


def test_ame_shapes_and_cost_match_the_paper():
    """32 vectors per DB vector, 16 matrices per query, all in R^(2d+6);
    64 d^2 + 416 d + 672 MACs a comparison against DCE's O(d)."""
    d = 10
    m = 2 * d + 6
    key = ame.keygen(d)
    P = np.random.default_rng(0).standard_normal((3, d))
    U, V = ame.encrypt(P, key)
    W = ame.trapgen(P[:1], key)
    assert U.shape == (3, 16, m) and V.shape == (3, 16, m)
    assert W.shape == (1, 16, m, m)
    assert key.Ma.shape[0] + key.Mb.shape[0] == 32
    for d in [96, 128, 960]:
        c_ame = ame.mac_cost_per_comparison(d)
        assert c_ame == jame.mac_cost_per_comparison(d)
        assert c_ame == 64 * d * d + 416 * d + 672
        assert c_ame / dce.mac_cost_per_comparison(d) > 15 * d / 4


def test_lsh_candidates_equal_the_reference():
    ds = synth.make_dataset("deep1m", n=3000, n_queries=30, k_gt=20, seed=1)
    kw = dict(dim=ds.d, n_tables=12, n_hashes=6, bucket_width=20.0, seed=0)
    idx, jidx = LSHIndex(**kw).build(ds.base), jlsh.LSHIndex(**kw).build(
        ds.base)
    assert np.array_equal(idx.A, jidx.A) and np.array_equal(idx.b, jidx.b)
    hit = 0
    for qi, q in enumerate(ds.queries[:20]):
        cand = idx.query(q)
        assert sorted(cand.tolist()) == sorted(jidx.query(q).tolist())
        hit += len(set(cand.tolist()) & set(ds.gt[qi, :10].tolist())) / 10
    assert hit / 20 > 0.5      # LSH needs many candidates — paper's point


def test_dataset_configs_equal_the_reference():
    assert datasets.DATASETS.keys() == jdatasets.DATASETS.keys()
    for name, cfg in datasets.DATASETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jdatasets.get_ann_config(name))
        assert datasets.get_ann_config(name) is cfg
