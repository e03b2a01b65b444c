"""Replicated shards and degraded-mode failover in the port
(`repro_torch.resilience`, `repro_torch.serving.sharded`), on the CPU,
in port form of tests/test_failover.py (n = 480, d = 16, 4 shards x 2
replicas over 8 logical devices).

The availability contract: one dead replica is invisible (equal ids,
`degraded=False`, no kernel build); a fully-dead group degrades the
answer instead of failing it (no id of the group's rows, stamped
`degraded` / `n_shards_down`); reviving restores the healthy ids; every
group down answers all -1.  The port skips a dead group's launches where
the JAX package masks its rows, so its answers are held to the JAX
package's: a subprocess with 8 simulated XLA devices (a test
process has one) runs the same keyless collections on the same
ciphertexts — flat, ivf, graph, and the int8 / pq8 ADC filters — and
every answer, healthy, degraded and revived, must be equal.  The
FaultPlan tests drive the port's schedulers as the JAX package's drive
its own.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch import resilience as R
from repro_torch.api import PlacementSpec
from repro_torch.api.protocol import PROTOCOL_VERSION, SearchResult
from repro_torch.core import dcpe, ppanns
from repro_torch.core.wireformat import pack
from repro_torch.data import synth
from repro_torch.launch.mesh import force_device_count
from repro_torch.serving.runtime import Collection, VirtualClock, \
    jit_cache_size
from repro_torch.serving.search_engine import SearchStats

D = 16
N = 480
K = 8
N_SHARDS = 4
CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT_S = 300
CASES = [("flat", None), ("ivf", None), ("graph", None), ("flat", "int8"),
         ("flat", "pq8")]


@pytest.fixture(autouse=True)
def _eight_logical_devices():
    force_device_count(8)
    yield
    force_device_count(None)


# ---------------------------------------------------------------------------
# ShardHealthRegistry semantics (no devices needed).
# ---------------------------------------------------------------------------

class TestHealthRegistry:
    def test_replica_masking_and_group_down(self):
        h = R.ShardHealthRegistry(4, 2)
        assert h.healthy and not h.degraded
        h.kill(1, 0)
        assert h.n_replicas_down == 1 and h.n_groups_down == 0
        assert not h.degraded                 # replica 1 still serves
        assert h.serve_mask().tolist() == [True] * 4
        h.kill(1, 1)
        assert h.degraded and h.n_groups_down == 1
        assert h.serve_mask().tolist() == [True, False, True, True]
        h.revive(1, 0)
        assert not h.degraded and h.n_replicas_down == 1
        h.revive(1, 1)
        assert h.healthy

    def test_epoch_bumps_only_on_real_transitions(self):
        h = R.ShardHealthRegistry(2, 2)
        e0 = h.epoch
        h.kill(0, 0)
        e1 = h.epoch
        assert e1 != e0
        h.kill(0, 0)                          # idempotent: no new epoch
        assert h.epoch == e1
        h.revive(1, 1)                        # already up: no new epoch
        assert h.epoch == e1
        h.revive(0, 0)
        assert h.epoch != e1

    def test_bounds_and_snapshot(self):
        h = R.ShardHealthRegistry(2, 1)
        with pytest.raises(ValueError, match="out of range"):
            h.kill(2, 0)
        with pytest.raises(ValueError, match="out of range"):
            h.kill(0, 1)
        h.kill(1, 0)
        snap = h.snapshot()
        assert snap["n_groups_down"] == 1 and snap["n_replicas_down"] == 1
        assert snap["up"].tolist() == [[True], [False]]
        with pytest.raises(ValueError):
            R.ShardHealthRegistry(0, 1)


# ---------------------------------------------------------------------------
# Wire surface: additive fields, old payloads decode healthy.
# ---------------------------------------------------------------------------

def _stats(**kw):
    base = dict(latency_s=0.0, filter_dist_evals=0, refine_comparisons=0,
                bytes_up=0, bytes_down=0, n_queries=1, backend="flat")
    base.update(kw)
    return SearchStats(**base)


class TestWireSurface:
    def test_search_result_roundtrips_degraded(self):
        res = SearchResult(ids=np.arange(6).reshape(2, 3),
                           stats=_stats(degraded=True, n_shards_down=2))
        back = SearchResult.from_bytes(res.to_bytes())
        assert back.degraded is True
        assert back.stats.n_shards_down == 2
        np.testing.assert_array_equal(back.ids, res.ids)

    def test_pre_resilience_payload_decodes_healthy(self):
        old_stats = {k: v for k, v in vars(_stats()).items()
                     if k not in ("degraded", "n_shards_down")}
        data = pack("search-result", PROTOCOL_VERSION,
                    arrays={"ids": np.zeros((1, 3), np.int64)},
                    meta={"stats": old_stats})
        back = SearchResult.from_bytes(data)
        assert back.degraded is False
        assert back.stats.n_shards_down == 0

    def test_placement_n_replicas_roundtrip_and_default(self):
        with pytest.raises(ValueError, match="n_replicas must be >= 1"):
            PlacementSpec(kind="sharded", n_shards=2, n_replicas=0)
        p = PlacementSpec(kind="sharded", n_shards=2, n_replicas=3)
        assert PlacementSpec.from_bytes(p.to_bytes()) == p
        assert p.resolve(8).n_replicas == 3
        d = p.to_dict()
        d.pop("n_replicas")
        assert PlacementSpec.from_dict(d).n_replicas == 1


# ---------------------------------------------------------------------------
# End-to-end failover, held to the JAX package's sharded answers.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def enc():
    """Numpy-encrypted rows and queries (the JAX package's encryptors,
    copied), fed to both packages' keyless collections."""
    ds = synth.make_dataset("sift1m", n=N, n_queries=4, d=D, k_gt=10,
                            seed=3)
    owner = ppanns.DataOwner(d=D, sap_beta=dcpe.suggest_beta(ds.base,
                                                             fraction=0.05),
                             seed=6)
    db = owner.encrypt_database(ds.base, build_index=False)
    user = ppanns.User(owner.share_keys())
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    return db.C_sap, db.C_dce, Q, T


def _collection(Coll, placement, backend, quant):
    """The same keyless sharded collection in either package."""
    kw = dict(n_partitions=8, nprobe=4) if backend == "ivf" else {}
    if quant == "pq8":
        kw["pq_m"] = 4
    if backend == "graph":
        kw.update(hnsw_M=8, hnsw_ef_construction=40)
    return Coll("t", f"fo-{backend}-{quant}", D, keyless=True, seed=6,
                backend=backend, quantization=quant, placement=placement,
                max_batch=4, max_wait_ms=1.0, **kw)


def _scenario(col, Q, T):
    """healthy, one replica down, group 1 down, revived, all down."""
    h = col.health
    out = {"healthy": col.search_batch(Q, T, K)}
    h.kill(1, 1)
    out["replica_down"] = col.search_batch(Q, T, K)
    h.kill(1, 0)
    out["group_down"] = col.search_batch(Q, T, K)
    h.revive(1, 0)
    h.revive(1, 1)
    out["revived"] = col.search_batch(Q, T, K)
    for s in range(N_SHARDS):
        h.kill(s, 0)
        h.kill(s, 1)
    out["all_down"] = col.search_batch(Q, T, K)
    for s in range(N_SHARDS):
        h.revive(s, 0)
        h.revive(s, 1)
    return {k: (np.asarray(ids), bool(st.degraded), int(st.n_shards_down))
            for k, (ids, st) in out.items()}


# The JAX package's side, with 8 simulated XLA devices: each case's
# collection over the same ciphertexts, through the same scenario.
REF_SCRIPT = r"""
import json, sys
from pathlib import Path
import numpy as np
import jax
from repro.api import PlacementSpec
from repro.serving.runtime import Collection

root = Path(sys.argv[1])
assert jax.device_count() == 8, jax.device_count()
z = np.load(root / "inputs.npz")
out = {}
for backend, quant in json.loads((root / "cases.json").read_text()):
    col = _collection(Collection, PlacementSpec(
        kind="sharded", n_shards=4, n_replicas=2), backend, quant)
    try:
        col.insert_encrypted(z["C_sap"], z["C_dce"])
        col.compact()
        res = _scenario(col, z["Q"], z["T"])
    finally:
        col.close()
    out[f"{backend}-{quant}"] = {k: [ids.tolist(), deg, down]
                                 for k, (ids, deg, down) in res.items()}
print("RESULT " + json.dumps(out))
"""


def _ref_script() -> str:
    """The reference script with this file's shared helpers, so both
    packages run literally the same scenario."""
    import inspect
    head = ("D, N, K, N_SHARDS = " + repr((D, N, K, N_SHARDS)) + "\n"
            + inspect.getsource(_collection) + "\n"
            + inspect.getsource(_scenario) + "\n")
    return REF_SCRIPT.replace("root = Path", head + "root = Path", 1)


@pytest.fixture(scope="module")
def reference(enc, tmp_path_factory):
    import json
    root = tmp_path_factory.mktemp("failover_ref")
    C_sap, C_dce, Q, T = enc
    np.savez(root / "inputs.npz", C_sap=C_sap, C_dce=C_dce, Q=Q, T=T)
    (root / "cases.json").write_text(json.dumps(CASES))
    (root / "ref.py").write_text(_ref_script())
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    try:
        out = subprocess.run([sys.executable, str(root / "ref.py"),
                              str(root)], env=env, capture_output=True,
                             text=True, timeout=REF_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the JAX reference run took over {REF_TIMEOUT_S} s")
    if out.returncode != 0:
        pytest.fail("the JAX reference run failed:\n" + out.stderr[-4000:])
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _port_collection(backend, quant):
    placement = PlacementSpec(kind="sharded", n_shards=N_SHARDS,
                              n_replicas=2)
    return _collection(lambda *a, **kw: Collection(*a, device=CPU, **kw),
                       placement, backend, quant)


@pytest.mark.parametrize("backend,quant", CASES)
def test_failover_matches_the_jax_sharded_reference(enc, reference,
                                                    backend, quant):
    C_sap, C_dce, Q, T = enc
    col = _port_collection(backend, quant)
    try:
        col.insert_encrypted(C_sap, C_dce)
        col.compact()
        got = _scenario(col, Q, T)
        per = col._backend._row_bucket(N) // N_SHARDS
    finally:
        col.close()
    want = reference[f"{backend}-{quant}"]
    for key, (ids, deg, down) in got.items():
        rids, rdeg, rdown = want[key]
        np.testing.assert_array_equal(ids, np.asarray(rids), err_msg=key)
        assert (deg, down) == (rdeg, rdown), key
    # the contract itself, on the port's answers
    assert got["healthy"][1:] == (False, 0)
    np.testing.assert_array_equal(got["replica_down"][0], got["healthy"][0])
    assert got["replica_down"][1:] == (False, 0)
    assert got["group_down"][1:] == (True, 1)
    returned = set(int(i) for i in got["group_down"][0].ravel() if i >= 0)
    assert returned and not (returned & set(range(per, 2 * per)))
    np.testing.assert_array_equal(got["revived"][0], got["healthy"][0])
    assert got["all_down"][1:] == (True, N_SHARDS)
    assert set(got["all_down"][0].ravel().tolist()) == {-1}


@pytest.mark.parametrize("backend", ["flat", "ivf", "graph"])
def test_failover_replica_group_revive(enc, backend):
    """The scheduled path answers the degraded batch's ids, with no
    kernel build in degraded mode, and telemetry counts the degraded
    answers."""
    C_sap, C_dce, Q, T = enc
    col = _port_collection(backend, None)
    try:
        col.insert_encrypted(C_sap, C_dce)
        col.compact()
        baseline = [col.search(q, t, K) for q, t in zip(Q, T)]
        health = col.health
        assert health is not None and health.n_replicas == 2
        health.kill(1, 1)
        for q, t, want in zip(Q, T, baseline):
            np.testing.assert_array_equal(col.search(q, t, K), want)
        health.kill(1, 0)
        got, statsd = col.search_batch(Q, T, K)
        assert statsd.degraded is True and statsd.n_shards_down == 1
        n_built = jit_cache_size()
        sched = [col.search(q, t, K) for q, t in zip(Q, T)]
        for row, srow in zip(got, sched):
            np.testing.assert_array_equal(row, srow)
        assert jit_cache_size() == n_built
        assert col.telemetry.snapshot()["n_degraded_answers"] >= 1
        health.revive(1, 0)
        health.revive(1, 1)
        for q, t, want in zip(Q, T, baseline):
            np.testing.assert_array_equal(col.search(q, t, K), want)
    finally:
        col.close()


# ---------------------------------------------------------------------------
# FaultPlan drives kill/revive/straggler deterministically.
# ---------------------------------------------------------------------------

def test_faultplan_kill_revive_through_scheduler(enc):
    C_sap, C_dce, Q, T = enc
    col = _port_collection("flat", None)
    try:
        col.insert_encrypted(C_sap, C_dce)
        plan = (R.FaultPlan()
                .kill_shard(at_call=2, shard=2, replica=0)
                .kill_shard(at_call=2, shard=2, replica=1)
                .revive_shard(at_call=4, shard=2)
                .revive_shard(at_call=4, shard=2, replica=1))
        plan.install(col)
        f1 = col.submit(Q[0], T[0], K, want_stats=True).result(timeout=30)
        assert f1[1].degraded is False          # call 1: healthy
        f2 = col.submit(Q[0], T[0], K, want_stats=True).result(timeout=30)
        assert f2[1].degraded is True           # call 2: group killed
        assert f2[1].n_shards_down == 1
        col.submit(Q[0], T[0], K).result(timeout=30)   # call 3: degraded
        f4 = col.submit(Q[0], T[0], K, want_stats=True).result(timeout=30)
        assert f4[1].degraded is False          # call 4: revived
        np.testing.assert_array_equal(f4[0], f1[0])
    finally:
        col.close()


def test_faultplan_straggler_advances_virtual_clock():
    clock = VirtualClock()

    class _Sched:
        def _run_batch(self, *a, **kw):
            return "ok"

    class _Col:
        batcher = _Sched()

    col = _Col()
    plan = R.FaultPlan(clock=clock).straggler(at_call=2, delay_s=0.75)
    plan.install(col)
    col.batcher._run_batch()
    t1 = clock.now()
    col.batcher._run_batch()                    # straggles
    assert clock.now() == pytest.approx(t1 + 0.75)
    col.batcher._run_batch()
    assert clock.now() == pytest.approx(t1 + 0.75)
    assert plan.n_engine_calls == 3


@pytest.mark.parametrize("placement_kind", ["single", "sharded"])
def test_faultplan_engine_error_then_quarantine(placement_kind):
    """An InjectedFault that outlives every retry attempt is quarantined
    to its own request; single and sharded placement alike."""
    placement = (PlacementSpec(kind="sharded", n_shards=2)
                 if placement_kind == "sharded" else None)
    col = Collection("t", "fp-q", D, seed=2, max_batch=4, max_wait_ms=1.0,
                     device=CPU, placement=placement)
    try:
        col.insert(np.random.default_rng(0).normal(
            size=(64, D)).astype(np.float32))
        user = col.new_user()
        q, t = user.encrypt_query(np.zeros(D, np.float32))
        plan = R.FaultPlan().engine_error(at_call=2, n=2)
        plan.install(col)
        ok1 = col.search(q, t, K)               # call 1 healthy
        with pytest.raises(R.InjectedFault):
            col.search(q, t, K)                 # calls 2+3 both fault
        np.testing.assert_array_equal(col.search(q, t, K), ok1)
        snap = col.telemetry.snapshot()
        assert snap["n_quarantined"] == 1
        assert snap["n_retries"] >= 1
    finally:
        col.close()
