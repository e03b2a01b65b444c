"""The port's leakage harness (`repro_torch.sec.leakage`) and its numpy
attacks (`core/{aspe,attacks}.py`) against the JAX package's, on the
CPU (the server's collection takes `device="cpu"`).

Held exactly:
  * the ASPE scheme and the §III KPA attacks of tests/test_attacks.py
    give equal outputs in both packages on the same inputs, and
    `aspe_kpa_attack` equal `AttackResult`s;
  * `dce_kpa_attack`, `access_pattern_attack` and `adc_code_attack` run
    on the JAX package's own `ServerView` arrays return `AttackResult`s
    equal to the JAX package's;
  * `capture_server_view` records bit-equal `touched`, `first_touched`
    and `codes_decoded` for every profile x (ivf, ivf+int8, graph) when
    both packages' owners hand out the same ciphertexts (the device
    encryptors draw their noise differently, so the test replaces both
    `DataOwner.encrypt_vectors` with one numpy encryption);
and the bars of tests/test_leakage.py hold in port form at its replay
scale (n 2048, d 32, 64 queries).
"""

import dataclasses

import numpy as np
import pytest

from repro.core import aspe as jaspe
from repro.core import attacks as jattacks
from repro.core import ppanns as jppanns
from repro.sec import leakage as jleakage
from repro_torch.core import aspe, attacks, dce, dcpe, ppanns
from repro_torch.sec import (AttackResult, ServerView,
                             access_pattern_attack, adc_code_attack,
                             aspe_kpa_attack, capture_server_view,
                             dce_kpa_attack, evaluate_profile)

N, D, NQ = 2048, 32, 64
CPU = "cpu"


def _same(a, b):
    """Equal nested outputs: arrays bit for bit, floats exactly."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


# ---------------------------------------------------------------------------
# ASPE and the §III attacks: numpy copies, equal outputs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transform", ["linear", "exp", "log", "square"])
def test_attacks_equal_the_jax_package(transform):
    d = 8 if transform == "square" else 12
    kw = dict(d=d, n=100, nq=60, transform=transform, seed=4)
    _same(attacks.attack_roundtrip(**kw), jattacks.attack_roundtrip(**kw))
    rep = attacks.attack_report(**kw)
    _same(rep, jattacks.attack_report(**kw))
    assert rep["query_success"] > 0.999 and rep["db_success"] > 0.999
    key, jkey = aspe.keygen(d, seed=4), jaspe.keygen(d, seed=4)
    _same(dataclasses.astuple(key), dataclasses.astuple(jkey))
    rng = np.random.default_rng(4)
    P, Q = rng.standard_normal((20, d)), rng.standard_normal((5, d))
    C, T = aspe.encrypt_db(P, key), aspe.encrypt_query(Q, key)
    _same((C, T), (jaspe.encrypt_db(P, jkey), jaspe.encrypt_query(Q, jkey)))
    _same(aspe.leak(C, T, key, transform), jaspe.leak(C, T, jkey, transform))


def test_attack_helpers_equal_the_jax_package():
    d = 8
    assert attacks.square_feature_dim(d) == jattacks.square_feature_dim(d)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, d))
    _same(attacks.random_guess_error(X), jattacks.random_guess_error(X))
    for err, base in ((0.0, 2.0), (2.0, 2.0), (5.0, 2.0), (1.0, 0.0),
                      (1.0, 2.0)):
        _same(attacks.normalized_success(err, base),
              jattacks.normalized_success(err, base))
    key = aspe.keygen(d)
    P = rng.standard_normal((d + 1, d))     # one too few leaked rows
    L = aspe.leak(aspe.encrypt_db(P, key), aspe.encrypt_query(P[:3], key),
                  key, "linear")
    for mod in (attacks, jattacks):
        with pytest.raises(ValueError, match="d\\+2"):
            mod.recover_queries_linear(P, L, "linear")


@pytest.mark.parametrize("transform", ["linear", "log"])
def test_aspe_kpa_attack_equals_the_jax_package(transform):
    res = aspe_kpa_attack(transform, seed=0)
    assert res.to_dict() == jleakage.aspe_kpa_attack(transform,
                                                     seed=0).to_dict()
    assert res.attack == f"aspe-kpa-{transform}" and res.success > 0.99


# ---------------------------------------------------------------------------
# The attacks on the JAX package's own server views.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_views():
    return {"perf": jleakage.capture_server_view("perf", "ivf", None, n=N,
                                                 d=D, nq=NQ, seed=0),
            "hardened": jleakage.capture_server_view(
                "hardened", "ivf", "int8", n=N, d=D, nq=NQ, seed=0)}


@pytest.mark.parametrize("which", ["perf", "hardened"])
def test_attacks_on_jax_views_are_equal(jax_views, which):
    jview = jax_views[which]
    view = ServerView(**dataclasses.asdict(jview))
    pairs = [(dce_kpa_attack, jleakage.dce_kpa_attack),
             (access_pattern_attack, jleakage.access_pattern_attack)]
    if jview.codes_decoded is not None:
        pairs.append((adc_code_attack, jleakage.adc_code_attack))
    else:
        with pytest.raises(ValueError, match="quantiz"):
            adc_code_attack(view)
    for mine, theirs in pairs:
        a, b = mine(view), theirs(jview)
        assert isinstance(a, AttackResult)
        assert a.to_dict() == b.to_dict()


# ---------------------------------------------------------------------------
# capture_server_view: bit-equal observables on equal ciphertexts.
# ---------------------------------------------------------------------------

def _numpy_encrypt(self, P, seed=None, device=None):
    """One encryption for both packages' owners (keys are bit-identical
    for the same seed): the numpy DCPE + DCE paths, fixed seeds."""
    return (dcpe.encrypt(P, self.keys.sap_key, seed=91).astype(np.float32),
            dce.encrypt(P, self.keys.dce_key, seed=92))


@pytest.mark.parametrize("backend,quant", [("ivf", None), ("ivf", "int8"),
                                           ("graph", None)])
@pytest.mark.parametrize("profile", ["perf", "balanced", "hardened",
                                     "oblivious-sketch"])
def test_server_view_equals_the_jax_package(monkeypatch, profile, backend,
                                            quant):
    monkeypatch.setattr(ppanns.DataOwner, "encrypt_vectors", _numpy_encrypt)
    monkeypatch.setattr(jppanns.DataOwner, "encrypt_vectors",
                        _numpy_encrypt)
    # the graph's owner build (host HNSW, M 16, ef_construction 200)
    # dominates: 128 rows keep it to ~1 s a package
    kw = dict(n=128 if backend == "graph" else 256, d=16, nq=8, seed=0)
    v = capture_server_view(profile, backend, quant, device=CPU, **kw)
    jv = jleakage.capture_server_view(profile, backend, quant, **kw)
    for f in ("profile", "backend", "C_sap", "C_dce", "Q_sap", "T_q",
              "touched", "first_touched", "codes_decoded", "P", "Q"):
        _same(getattr(v, f), getattr(jv, f))
    assert v.touched.any() and (quant is None) == (v.codes_decoded is None)


# ---------------------------------------------------------------------------
# The bars of tests/test_leakage.py, in port form.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def perf_view():
    return capture_server_view("perf", "ivf", None, n=N, d=D, nq=NQ,
                               seed=0, device=CPU)


def test_server_view_shapes(perf_view):
    v = perf_view
    assert v.profile == "perf" and v.backend == "ivf"
    assert v.C_sap.shape == (N, D) and v.Q_sap.shape == (NQ, D)
    cdim = dce.ciphertext_dim(D)
    assert v.C_dce.shape == (N, 4, cdim) and v.T_q.shape == (NQ, cdim)
    assert v.touched.shape == v.first_touched.shape == (NQ, N)
    assert v.touched.dtype == v.first_touched.dtype == np.bool_
    assert v.codes_decoded is None
    assert 0 < v.first_touched.sum() < v.touched.sum() < NQ * N
    assert (v.first_touched <= v.touched).all()


def test_dce_sign_channel_at_chance(perf_view):
    res = dce_kpa_attack(perf_view)
    assert res.attack == "dce-kpa-sign"
    assert res.success <= 0.05


def test_access_pattern_leaks_under_perf(perf_view):
    res = access_pattern_attack(perf_view)
    assert res.attack == "access-pattern"
    assert res.success >= 0.2
    assert 0 < res.err < res.baseline


def test_hardened_at_chance_on_every_attack():
    results = evaluate_profile("hardened", "ivf", "int8", n=N, d=D, nq=NQ,
                               seed=0, device=CPU)
    assert [r.attack for r in results] == [
        "dce-kpa-sign", "access-pattern", "adc-code-pattern"]
    for r in results:
        assert r.profile == "hardened" and r.backend == "ivf+int8"
        assert r.success <= 0.05, r


def test_oblivious_view_touches_everything():
    v = capture_server_view("hardened", "ivf", None, n=256, d=16, nq=4,
                            seed=0, device=CPU)
    assert v.touched.all() and v.first_touched.all()


@pytest.fixture(scope="module")
def graph_views():
    return {p: capture_server_view(p, "graph", None, n=N, d=D, nq=NQ,
                                   seed=0, device=CPU)
            for p in ("perf", "hardened")}


def test_graph_scan_trace_is_the_access_pattern(graph_views):
    for v in graph_views.values():
        assert v.touched.shape == (NQ, N)
        assert 0 < v.touched.sum() < NQ * N
        np.testing.assert_array_equal(v.touched, v.first_touched)


def test_graph_perf_leaks_access_pattern(graph_views):
    res = access_pattern_attack(graph_views["perf"])
    assert res.backend == "graph"
    assert res.success >= 0.15
    assert 0 < res.err < res.baseline


def test_graph_hardened_is_the_intermediate_tier(graph_views):
    res = access_pattern_attack(graph_views["hardened"])
    assert res.success > 0.05
    assert dce_kpa_attack(graph_views["hardened"]).success <= 0.05


def test_entry_points_default_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        capture_server_view("perf", "ivf", n=64, d=8, nq=2)
