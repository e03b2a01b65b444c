"""The port's LM server (`repro_torch.serving.LMServer`), the kNN-LM loop
of examples/rag_serving.py and the serve entry point (`repro_torch.launch.
serve`) against the JAX package, on the CPU.

Both packages compute with the same weights (the reference's, through
`convert.params_from_numpy`) and search the same ciphertexts with the
same keys and query seeds.  Held exactly:
  * greedy tokens of `LMServer.generate` (smoke qwen3, float32: the
    logits agree to ~1e-6 and no greedy step is that close to a tie);
  * the first generated token = argmax of `forward` at the last
    position (tests/test_serving.py in port form);
  * the kNN-LM loop's retrieved ids at every step and its blended
    tokens;
  * the serve entry point's sidecar ids, with both owners' `encrypt_vectors`
    replaced by one numpy encryption and the query clients seeded (the
    reference's draws fresh entropy for both);
  * `serving.__all__`.
"""

import dataclasses
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import serving as jserving
from repro.configs import get_config as jget_config
from repro.core import dce, dcpe
from repro.core import ppanns as jppanns
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro_torch import api, serving
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import ppanns
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import LMServer
from repro_torch.serving.engine import greedy

CPU = "cpu"


@pytest.fixture(scope="module")
def qwen():
    """The smoke qwen3 of tests/test_serving.py: the reference's model
    and weights, and the port's model holding the same weights."""
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b").smoke(),
                               remat=False)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("qwen3-1.7b").smoke(), remat=False)
    model = Model(cfg, device=CPU, seed=None)
    model.load_state_dict(params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return jm, params, model


def test_serving_exports_equal_the_reference():
    assert serving.__all__ == jserving.__all__
    for name in serving.__all__:
        assert getattr(serving, name).__name__ == name


def test_search_engine_import_leaves_the_lm_stack_out():
    code = ("import sys; import repro_torch.serving.search_engine, "
            "repro_torch.serving; from repro_torch.serving import "
            "SecureSearchEngine; assert 'repro_torch.models' not in "
            "sys.modules, 'models imported'; from repro_torch.serving "
            "import LMServer; assert 'repro_torch.models' in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_generate_greedy_equals_the_reference(qwen):
    jm, params, model = qwen
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jserving.LMServer(jm, params).generate(
        {"tokens": jnp.asarray(toks)}, max_new_tokens=6))
    got = LMServer(model).generate({"tokens": torch.from_numpy(toks)},
                                   max_new_tokens=6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    # the first generated token is the argmax of the forward logits
    full = model.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  full[:, -1].argmax(-1).numpy())


def _family_pair(arch):
    """The reference's smoke model and weights for `arch`, and the port's
    model holding the same weights."""
    jcfg = dataclasses.replace(jget_config(arch).smoke(), remat=False)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch).smoke(), remat=False)
    model = Model(cfg, device=CPU, seed=None)
    model.load_state_dict(params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return jm, params, model


def test_lm_generate_ssm_family():
    """tests/test_serving.py's test_lm_generate_ssm_family in port form,
    with the reference's tokens held too."""
    jm, params, model = _family_pair("mamba2-370m")
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (2, 8)).astype(np.int32)
    out = LMServer(model).generate({"tokens": torch.from_numpy(toks)},
                                   max_new_tokens=3)
    assert out.shape == (2, 3)
    want = jserving.LMServer(jm, params).generate(
        {"tokens": jnp.asarray(toks)}, max_new_tokens=3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-small",
                                  "grok-1-314b"])
def test_generate_greedy_equals_the_reference_families(arch):
    """Greedy tokens of the hybrid, encdec and moe families (grok-1 at
    its own capacity factor 1.25, so the prefill may drop assignments as
    the reference's does) equal the reference's."""
    jm, params, model = _family_pair(arch)
    cfg = model.cfg
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12))
             .astype(np.int32)}
    if cfg.family == "encdec":
        batch["enc_input"] = rng.standard_normal(
            (2, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    want = np.asarray(jserving.LMServer(jm, params).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, max_new_tokens=6))
    got = LMServer(model).generate(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        max_new_tokens=6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_breaks_ties_to_the_first_index():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]],
                          dtype=torch.bfloat16)
    assert greedy(logits).tolist() == [1, 0]
    assert greedy(logits).tolist() == \
        np.asarray(jnp.argmax(jnp.asarray(logits.float().numpy()), -1)
                   ).tolist()


def test_temperature_sampling_draws_from_the_generator(qwen):
    _, _, model = qwen
    toks = torch.zeros((2, 5), dtype=torch.int32)
    server = LMServer(model)
    a = server.generate({"tokens": toks}, 5, temperature=0.8,
                        generator=torch.Generator().manual_seed(3))
    b = server.generate({"tokens": toks}, 5, temperature=0.8,
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (2, 5)
    assert int(a.min()) >= 0 and int(a.max()) < model.cfg.vocab_size


# ---------------------------------------------------------------------------
# The kNN-LM loop of examples/rag_serving.py, in both packages.
# ---------------------------------------------------------------------------

N_STORE, B, K, LAM, STEPS, PROMPT = 2000, 2, 8, 0.3, 8, 16


def _blend(logits, knn_tokens):
    knn_logits = np.full(logits.shape, -1e30, np.float32)
    for b in range(logits.shape[0]):
        knn_logits[b, knn_tokens[b]] = 0.0
    return ((1 - LAM) * logits + LAM * knn_logits).argmax(-1)


def _jax_knn_lm(jm, params, svc, user, store_tok, toks):
    cache = jm.init_cache(B, PROMPT + STEPS)
    logits, cache = jm.prefill(params, {"tokens": jnp.asarray(toks)}, cache)
    ids, out = [], []
    for _ in range(STEPS):
        probe = np.asarray(jnp.take(params["embed"]["tokens"],
                                    jnp.argmax(logits, -1), axis=0),
                           np.float32)
        nbr = svc.submit(user.request("lm", "datastore", probe,
                                      japi.SearchParams(k=K))).ids
        nxt = _blend(np.asarray(logits), store_tok[nbr]).astype(np.int32)
        ids.append(nbr)
        out.append(nxt)
        logits, cache = jm.decode_step(params, jnp.asarray(nxt)[:, None],
                                       cache)
    return np.stack(ids), np.stack(out, 1)


def _port_knn_lm(model, svc, user, store_tok, toks):
    cache = model.init_cache(B, PROMPT + STEPS)
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks)}, cache)
    ids, out = [], []
    for _ in range(STEPS):
        probe = model.embed["tokens"][greedy(logits)].float().numpy()
        nbr = svc.submit(user.request("lm", "datastore", probe,
                                      api.SearchParams(k=K))).ids
        nxt = _blend(logits.numpy(), store_tok[nbr]).astype(np.int32)
        ids.append(nbr)
        out.append(nxt)
        logits, cache = model.decode_step(torch.from_numpy(nxt)[:, None],
                                          cache)
    return np.stack(ids), np.stack(out, 1)


def test_knn_lm_loop_equals_the_reference(qwen):
    jm, params, model = qwen
    cfg = model.cfg
    rng = np.random.default_rng(0)
    store_emb = rng.standard_normal((N_STORE, cfg.d_model)).astype(
        np.float32)
    store_tok = rng.integers(0, cfg.vocab_size, N_STORE).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    kw = dict(tenant="lm", name="datastore", d=cfg.d_model, backend="flat",
              sap_beta=1.0, seed=1)
    owner = api.DataOwnerClient(api.IndexSpec(**kw))
    jowner = japi.DataOwnerClient(japi.IndexSpec(**kw))
    assert owner.keys.to_bytes() == jowner.keys.to_bytes()
    C_sap, C_dce = owner.encrypt_vectors(store_emb, seed=5, device=CPU)

    with api.SecureAnnService(device=CPU) as svc:
        svc.create_collection(api.IndexSpec(**kw))
        svc.insert("lm", "datastore", C_sap, C_dce)
        ids, out = _port_knn_lm(model, svc, owner.query_client(seed=9),
                                store_tok, toks)
    jsvc = japi.SecureAnnService()
    try:
        jsvc.create_collection(japi.IndexSpec(**kw))
        jsvc.insert("lm", "datastore", C_sap, C_dce)
        jids, jout = _jax_knn_lm(jm, params, jsvc,
                                 jowner.query_client(seed=9), store_tok,
                                 toks)
    finally:
        jsvc.close()
    assert ids.shape == (STEPS, B, K) and (ids >= 0).all()
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(out, jout)
    # every blended token is one of that step's retrieved next tokens
    assert all(out[b, s] in store_tok[ids[s, b]]
               for s in range(STEPS) for b in range(B))


# ---------------------------------------------------------------------------
# The serve entry point.
# ---------------------------------------------------------------------------

def _numpy_encrypt(self, P, seed=None, device=None):
    """One encryption for both packages' owners (keys are bit-identical
    for the same spec seed): the numpy DCPE + DCE paths, fixed seeds."""
    return (dcpe.encrypt(P, self.keys.sap_key, seed=91).astype(np.float32),
            dce.encrypt(P, self.keys.dce_key, seed=92))


def _recording(mod, monkeypatch):
    """Seed `mod`'s query clients and record each request's ids by its
    query ciphertext."""
    seen, lock = {}, threading.Lock()
    submit = mod.SecureAnnService.submit
    query_client = mod.DataOwnerClient.query_client

    def recorded(self, req):
        res = submit(self, req)
        with lock:
            seen[req.query.C_sap.tobytes()] = res.ids
        return res

    monkeypatch.setattr(mod.SecureAnnService, "submit", recorded)
    monkeypatch.setattr(mod.DataOwnerClient, "query_client",
                        lambda self, seed=None: query_client(self, seed=33))
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_serves_every_arch(arch, capsys):
    """`--arch` takes every arch the reference CLI takes (whisper's
    batch carries its `enc_input` stub)."""
    out = serve.main(["--arch", arch, "--device", CPU])
    assert isinstance(out, torch.Tensor) and out.shape == (4, 16)
    assert out.dtype == torch.int32
    vocab = get_config(arch).smoke().vocab_size
    assert int(out.min()) >= 0 and int(out.max()) < vocab
    assert "generated (4, 16)" in capsys.readouterr().out


def test_serve_main_returns_tokens_and_the_reference_ids(monkeypatch):
    monkeypatch.setattr(ppanns.DataOwner, "encrypt_vectors", _numpy_encrypt)
    monkeypatch.setattr(jppanns.DataOwner, "encrypt_vectors",
                        _numpy_encrypt)
    mine, theirs = _recording(api, monkeypatch), _recording(japi,
                                                            monkeypatch)
    argv = ["--secure-ann", "--ann-db-size", "2000", "--batch", "3",
            "--prompt-len", "10", "--new-tokens", "5"]
    out = serve.main(argv + ["--device", CPU])
    assert isinstance(out, torch.Tensor) and out.shape == (3, 5)
    assert out.device.type == "cpu"
    jout = jserve.main(argv)
    assert jout.shape == (3, 5)
    assert len(mine) == 16 and mine.keys() == theirs.keys()
    for q in mine:
        np.testing.assert_array_equal(mine[q], theirs[q])
