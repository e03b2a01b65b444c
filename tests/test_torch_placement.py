"""Sharded placement in the port (`repro_torch.serving.sharded`,
`repro_torch.launch.mesh`) against the JAX package, on the CPU (every
service takes `device="cpu"`: the plain PyTorch versions of the
kernels), in port form of tests/test_placement.py (n = 600, d = 16).

Held exactly:
  * PlacementSpec validates and resolves as in the JAX package, with the
    device count of `launch.mesh` (the forced logical count here, the
    counterpart of `--xla_force_host_platform_device_count`);
  * the port's sharded ids at 1, 2 and 8 logical devices equal the JAX
    package's single-device ids on the same ciphertexts, for flat, ivf
    and the ADC int8 / pq8 filters (flat and ivf), batch and coalesced —
    the JAX package's own sharded-vs-single contract;
  * live ingestion and deletes keep stable global ids; the shard
    manifest covers the rows;
  * against the JAX package's 2-shard collections (flat, ivf and the
    per-shard graph), run in a subprocess with 8 simulated XLA devices
    (a test process has one): equal ids after the same inserts
    and deletes, equal `.ppcol` bytes, and each package loads the other's
    sharded file with equal ids;
  * a warmed-up sharded collection serves with no kernel build;
  * with two real devices (the host standing in for two cards) the
    layout and merges answer as with one.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import api as japi
from repro_torch import api
from repro_torch.api import (DataOwnerClient, IndexSpec, PlacementSpec,
                             QueryClient, SearchParams, SearchRequest,
                             SecureAnnService, WireFormatError,
                             suggest_beta)
from repro_torch.core.wireformat import pack, unpack
from repro_torch.data import synth
from repro_torch.launch.mesh import force_device_count, local_devices
from repro_torch.serving.runtime.telemetry import jit_cache_size

D = 16
N = 600
CPU = "cpu"
SHARD_COUNTS = (1, 2, 8)
GRAPH_KW = dict(hnsw_M=8, hnsw_ef_construction=40)
ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def _eight_logical_devices():
    """Eight logical placement devices on the host, as the JAX package's
    CI forces eight XLA devices; reset after each test (the setting is
    process-wide and test files share worker processes)."""
    force_device_count(8)
    yield
    force_device_count(None)


@pytest.fixture(scope="module")
def ds():
    return synth.make_dataset("sift1m", n=N, n_queries=6, d=D, k_gt=10,
                              seed=0)


@pytest.fixture(scope="module")
def owner_and_query(ds):
    spec = IndexSpec(tenant="t", name="base", d=D,
                     sap_beta=suggest_beta(ds.base, fraction=0.05), seed=5)
    owner = DataOwnerClient(spec)
    C_sap, C_dce = owner.encrypt_vectors(ds.base, seed=11, device=CPU)
    extra = owner.encrypt_vectors(ds.base[:5], seed=77, device=CPU)
    planted = owner.encrypt_vectors(ds.queries[0][None], seed=99,
                                    device=CPU)
    user = owner.query_client()
    return spec, C_sap, C_dce, user.encrypt_queries(ds.queries), extra, \
        planted


def _spec(base, backend: str, name: str, quant=None):
    extra = dict(n_partitions=8, nprobe=3) if backend == "ivf" else {}
    if quant is not None:
        extra = dict(quantization=quant, n_partitions=16, nprobe=16)
    if backend == "graph":
        extra = dict(GRAPH_KW)
    return dataclasses.replace(base, name=name, backend=backend, **extra)


def _request(mod, query, name, k=8, ratio_k=6.0, coalesce=False):
    q = mod.EncryptedQuery(C_sap=query.C_sap, T=query.T)
    return mod.SearchRequest(tenant="t", collection=name, query=q,
                             params=mod.SearchParams(k=k, ratio_k=ratio_k),
                             coalesce=coalesce)


# ---------------------------------------------------------------------------
# Wire round-trips, validation, the device count.
# ---------------------------------------------------------------------------

def test_placement_wire_roundtrip():
    for pl in (PlacementSpec(),
               PlacementSpec(kind="sharded"),
               PlacementSpec(kind="sharded", data_axis="x", n_shards=4)):
        assert PlacementSpec.from_bytes(pl.to_bytes()) == pl
        jpl = japi.PlacementSpec.from_bytes(pl.to_bytes())
        assert jpl.to_bytes() == pl.to_bytes()
    assert PlacementSpec().kind == "single"
    assert PlacementSpec(kind="sharded", n_shards=4).is_sharded


def test_placement_rejects_unknown_kind_and_fields():
    with pytest.raises(ValueError, match="unknown placement kind"):
        PlacementSpec(kind="ring")
    payload = pack("placement-spec", 1, arrays={},
                   meta={"kind": "ring", "data_axis": "data",
                         "n_shards": 2})
    with pytest.raises(WireFormatError, match="unknown placement kind"):
        PlacementSpec.from_bytes(payload)
    with pytest.raises(WireFormatError, match="unknown fields"):
        PlacementSpec.from_dict({"kind": "single", "data_axis": "data",
                                 "n_shards": None, "rack": 3})
    with pytest.raises(ValueError, match="n_shards"):
        PlacementSpec(kind="single", n_shards=4)
    with pytest.raises(ValueError, match="n_shards must be"):
        PlacementSpec(kind="sharded", n_shards=0)


def test_placement_resolve_pins_device_count():
    pl = PlacementSpec(kind="sharded")
    assert pl.n_shards is None
    resolved = pl.resolve(4)
    assert resolved.n_shards == 4
    assert resolved.resolve(4) == resolved          # idempotent
    with pytest.raises(ValueError, match="device"):
        PlacementSpec(kind="sharded", n_shards=9).resolve(8)
    assert PlacementSpec().resolve(8) == PlacementSpec()


def test_local_devices_follow_the_forced_count():
    """Logical device s lives on real device s % n_real; without a
    forced count the host is one device."""
    assert local_devices(CPU) == [local_devices(CPU)[0]] * 8
    force_device_count(3)
    assert len(local_devices(CPU)) == 3
    force_device_count(None)
    assert len(local_devices(CPU)) == 1
    with pytest.raises(ValueError):
        force_device_count(0)


def test_sharded_rejects_hnsw_and_too_many_shards(ds, owner_and_query):
    spec, *_ = owner_and_query
    hspec = dataclasses.replace(spec, name="h", backend="hnsw")
    with SecureAnnService(device=CPU) as svc:
        with pytest.raises(ValueError, match="does not shard"):
            svc.create_collection(hspec,
                                  placement=PlacementSpec(kind="sharded"))
        with pytest.raises(ValueError, match="device"):
            svc.create_collection(
                dataclasses.replace(spec, name="wide"),
                placement=PlacementSpec(kind="sharded", n_shards=9))
        spec1 = svc.create_collection(
            dataclasses.replace(spec, name="all"),
            placement=PlacementSpec(kind="sharded"))
        assert svc.placement("t", spec1.name).n_shards == 8


# ---------------------------------------------------------------------------
# Sharded vs the JAX package's single device: exact ids.
# ---------------------------------------------------------------------------

_SINGLE_REF: dict = {}


def _jax_single(spec, owner_and_query, coalesce: bool):
    """The JAX package's single-device ids for spec on the same
    ciphertexts (cached per spec and path)."""
    key = (spec.name, coalesce)
    if key not in _SINGLE_REF:
        _, C_sap, C_dce, query, *_ = owner_and_query
        jspec = japi.IndexSpec.from_bytes(spec.to_bytes())
        with japi.SecureAnnService() as svc:
            svc.create_collection(jspec)
            svc.insert("t", spec.name, C_sap, C_dce)
            _SINGLE_REF[(spec.name, False)] = svc.submit(
                _request(japi, query, spec.name)).ids
            _SINGLE_REF[(spec.name, True)] = svc.submit(_request(
                japi, dataclasses.replace(query, C_sap=query.C_sap[:1],
                                          T=query.T[:1]),
                spec.name, coalesce=True)).ids
    return _SINGLE_REF[key]


@pytest.mark.parametrize("n_dev", SHARD_COUNTS)
@pytest.mark.parametrize("backend", ["flat", "ivf"])
def test_sharded_matches_single_host_exactly(ds, owner_and_query, backend,
                                             n_dev):
    """The acceptance bar: a sharded collection over n_dev logical
    devices (`n_shards=None` resolves to n_dev) answers with the ids of
    the JAX package's single-device collection — batch path and
    coalesced single-query path both."""
    force_device_count(n_dev)
    spec0, C_sap, C_dce, query, *_ = owner_and_query
    spec = _spec(spec0, backend, f"par-{backend}")
    with SecureAnnService(device=CPU) as svc:
        svc.create_collection(spec, placement=PlacementSpec(kind="sharded"))
        assert svc.placement("t", spec.name).n_shards == n_dev
        svc.insert("t", spec.name, C_sap, C_dce)
        res = svc.submit(_request(api, query, spec.name))
        assert res.stats.backend == f"sharded-{backend}"
        np.testing.assert_array_equal(
            res.ids, _jax_single(spec, owner_and_query, False))
        one = svc.submit(_request(
            api, dataclasses.replace(query, C_sap=query.C_sap[:1],
                                     T=query.T[:1]),
            spec.name, coalesce=True)).ids
        np.testing.assert_array_equal(
            one, _jax_single(spec, owner_and_query, True))


@pytest.mark.parametrize("n_dev", SHARD_COUNTS)
@pytest.mark.parametrize("quant", ["int8", "pq8"])
def test_sharded_adc_matches_single_device_adc(ds, owner_and_query, quant,
                                               n_dev):
    """A quantized sharded collection (K4 / K5 once per shard on the card,
    their plain versions here) returns the JAX package's quantized
    single-device ids, flat and ivf."""
    force_device_count(n_dev)
    spec0, C_sap, C_dce, query, *_ = owner_and_query
    for backend in ("flat", "ivf"):
        spec = _spec(spec0, backend, f"adc-{quant}-{backend}", quant)
        with SecureAnnService(device=CPU) as svc:
            svc.create_collection(spec, placement=PlacementSpec(
                kind="sharded", n_shards=n_dev))
            svc.insert("t", spec.name, C_sap, C_dce)
            res = svc.submit(_request(api, query, spec.name))
            assert res.stats.backend == f"sharded-adc-{backend}-{quant}"
            np.testing.assert_array_equal(
                res.ids, _jax_single(spec, owner_and_query, False))


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_live_ingestion_and_deletes(ds, owner_and_query, n_shards):
    """Inserts route to a shard with stable global ids and are visible
    to the next search; deleted ids never come back."""
    spec0, C_sap, C_dce, query, _, planted = owner_and_query
    spec = _spec(spec0, "flat", f"mut-{n_shards}")
    with SecureAnnService(device=CPU) as svc:
        svc.create_collection(spec, placement=PlacementSpec(
            kind="sharded", n_shards=n_shards))
        rows = svc.insert("t", spec.name, C_sap, C_dce)
        assert np.array_equal(rows, np.arange(N))      # stable global ids
        new = svc.insert("t", spec.name, *planted)
        assert new[0] == N                             # appended, stable
        req = _request(api, query, spec.name, ratio_k=8.0)
        assert int(new[0]) in svc.submit(req).ids[0]
        svc.delete("t", spec.name, new)
        assert int(new[0]) not in svc.submit(req).ids
        manifest = svc.collection("t", spec.name).shard_manifest()
        assert len(manifest) == n_shards
        assert manifest[-1]["row_stop"] == N + 1
        assert sum(m["row_stop"] - m["row_start"] for m in manifest) \
            == N + 1
        assert sum(m["n_alive"] for m in manifest) == N


def test_sharded_zero_rebuilds_after_warmup(ds, owner_and_query):
    spec0, C_sap, C_dce, query, *_ = owner_and_query
    spec = _spec(spec0, "flat", "warm")
    with SecureAnnService(device=CPU) as svc:
        svc.create_collection(spec, placement=PlacementSpec(
            kind="sharded", n_shards=2))
        svc.insert("t", spec.name, C_sap, C_dce)
        svc.warmup("t", spec.name, k=8)
        before = jit_cache_size()
        user = QueryClient(DataOwnerClient(spec0).keys, seed=7)
        for q in ds.queries:
            svc.submit(SearchRequest(tenant="t", collection=spec.name,
                                     query=user.encrypt_query(q),
                                     params=SearchParams(k=8)))
        assert jit_cache_size() == before, "steady-state traffic rebuilt"


def test_sharded_adc_mutation_and_save_load(ds, owner_and_query, tmp_path):
    spec0, C_sap, C_dce, query, _, planted = owner_and_query
    spec = dataclasses.replace(spec0, name="adc-mut", quantization="int8")
    req = _request(api, query, spec.name, ratio_k=8.0)
    with SecureAnnService(device=CPU) as svc:
        svc.create_collection(spec, placement=PlacementSpec(
            kind="sharded", n_shards=2))
        svc.insert("t", spec.name, C_sap, C_dce)
        new = svc.insert("t", spec.name, *planted)
        assert int(new[0]) in svc.submit(req).ids[0]
        svc.delete("t", spec.name, new)
        ids_before = svc.submit(req).ids
        assert int(new[0]) not in ids_before
        svc.save(tmp_path / "snap")
    with SecureAnnService.load(tmp_path / "snap", device=CPU) as svc2:
        np.testing.assert_array_equal(svc2.submit(req).ids, ids_before)


# ---------------------------------------------------------------------------
# Against the JAX package's 2-shard collections (8 simulated devices, in a
# subprocess): ids, .ppcol bytes, cross-loads.
# ---------------------------------------------------------------------------

CROSS_BACKENDS = ("flat", "ivf", "graph")

# The JAX package's side, run with 8 simulated XLA devices: the same
# sharded collections and mutations as the port's, their ids and .ppcol
# files, and the port's .ppcol files loaded and searched.
REF_SCRIPT = r"""
import json, sys
from pathlib import Path
import numpy as np
import jax
from repro import api

root = Path(sys.argv[1])
assert jax.device_count() == 8, jax.device_count()
z = np.load(root / "inputs.npz")
specs = json.loads((root / "specs.json").read_text())
query = api.EncryptedQuery(C_sap=z["Q"], T=z["T"])
out = {}
for backend, d in specs.items():
    spec = api.IndexSpec.from_dict(d)
    req = api.SearchRequest(tenant="t", collection=spec.name, query=query,
                            params=api.SearchParams(k=8, ratio_k=6.0),
                            coalesce=False)
    with api.SecureAnnService() as svc:
        svc.create_collection(spec, placement=api.PlacementSpec(
            kind="sharded", n_shards=2))
        svc.insert("t", spec.name, z["C_sap"], z["C_dce"])
        svc.submit(req)
        extra = svc.insert("t", spec.name, z["x_sap"], z["x_dce"])
        svc.delete("t", spec.name, [int(extra[0]), 3])
        out["ids/" + backend] = svc.submit(req).ids.tolist()
        svc.save(root / "jax" / backend)
    with api.SecureAnnService.load(root / "torch" / backend) as svc:
        out["loaded/" + backend] = svc.submit(req).ids.tolist()
print("RESULT " + json.dumps(out))
"""


def run_reference(script: str, root: Path, timeout: int = REF_TIMEOUT_S):
    """Run the JAX package's side in a subprocess with 8 simulated XLA
    devices; its last line is 'RESULT <json>'.  A failure fails the
    test."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    (root / "ref.py").write_text(script)
    try:
        out = subprocess.run([sys.executable, str(root / "ref.py"),
                              str(root)], env=env, capture_output=True,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the JAX reference run took over {timeout} s")
    if out.returncode != 0:
        pytest.fail("the JAX reference run failed:\n" + out.stderr[-4000:])
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return {k: np.asarray(v) for k, v in
            json.loads(line[len("RESULT "):]).items()}


@pytest.fixture(scope="module")
def cross(owner_and_query, tmp_path_factory):
    """The port's 2-shard collections (search, insert, delete, search,
    save), then the JAX package's same runs in the subprocess."""
    spec0, C_sap, C_dce, query, (x_sap, x_dce), _ = owner_and_query
    root = tmp_path_factory.mktemp("placement_ref")
    ids, specs = {}, {}
    force_device_count(8)
    try:
        for backend in CROSS_BACKENDS:
            spec = _spec(spec0, backend, f"x-{backend}")
            specs[backend] = spec.to_dict()
            req = _request(api, query, spec.name)
            with SecureAnnService(device=CPU) as svc:
                svc.create_collection(spec, placement=PlacementSpec(
                    kind="sharded", n_shards=2))
                svc.insert("t", spec.name, C_sap, C_dce)
                svc.submit(req)
                extra = svc.insert("t", spec.name, x_sap, x_dce)
                svc.delete("t", spec.name, [int(extra[0]), 3])
                ids[backend] = svc.submit(req).ids
                svc.save(root / "torch" / backend)
    finally:
        force_device_count(None)
    np.savez(root / "inputs.npz", C_sap=C_sap, C_dce=C_dce, Q=query.C_sap,
             T=query.T, x_sap=x_sap, x_dce=x_dce)
    (root / "specs.json").write_text(json.dumps(specs))
    return root, ids, run_reference(REF_SCRIPT, root)


@pytest.mark.parametrize("backend", CROSS_BACKENDS)
def test_sharded_ids_and_ppcol_match_the_jax_sharded_reference(
        cross, owner_and_query, backend):
    root, ids, ref = cross
    query = owner_and_query[3]
    np.testing.assert_array_equal(ids[backend], ref[f"ids/{backend}"])
    assert 3 not in ids[backend]
    (mine,) = (root / "torch" / backend).glob("*.ppcol")
    (theirs,) = (root / "jax" / backend).glob("*.ppcol")
    assert mine.name == theirs.name
    assert mine.read_bytes() == theirs.read_bytes()
    _, meta = unpack(mine.read_bytes(), "encrypted-collection", 1)
    assert meta["placement"]["kind"] == "sharded"
    assert meta["placement"]["n_shards"] == 2
    assert len(meta["shard_manifest"]) == 2
    # the JAX package loaded the port's file; the port loads the JAX one
    np.testing.assert_array_equal(ref[f"loaded/{backend}"], ids[backend])
    with SecureAnnService.load(root / "jax" / backend, device=CPU) as svc:
        name = f"x-{backend}"
        assert svc.placement("t", name).n_shards == 2
        got = svc.submit(_request(api, query, name)).ids
        np.testing.assert_array_equal(got, ids[backend])


# ---------------------------------------------------------------------------
# Several real devices in one process: the layout, exercised on the host.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,quant", [("flat", None), ("ivf", None),
                                           ("flat", "int8"),
                                           ("flat", "pq8"),
                                           ("graph", None)])
def test_two_real_devices_answer_as_one(monkeypatch, owner_and_query,
                                        backend, quant):
    """With two real devices, logical shards 0, 2 live on the first and
    1, 3 on the second: each device holds its shards' blocks in one
    tensor, the merges run on the refine device.  The host stands in for
    two cards (cpu:0, cpu:1 are distinct devices of one memory), so this
    holds the layout's bookkeeping, not the copies between cards."""
    import torch
    from repro_torch.launch import mesh
    from repro_torch.serving.sharded import RowSharded
    spec0, C_sap, C_dce, query, (x_sap, x_dce), _ = owner_and_query
    spec = _spec(spec0, backend, f"two-{backend}", quant)
    force_device_count(4)

    def run():
        with SecureAnnService(device=CPU) as svc:
            svc.create_collection(spec, placement=PlacementSpec(
                kind="sharded", n_shards=4))
            svc.insert("t", spec.name, C_sap, C_dce)
            svc.submit(_request(api, query, spec.name))
            extra = svc.insert("t", spec.name, x_sap, x_dce)
            svc.delete("t", spec.name, [int(extra[0]), 3])
            b = svc.collection("t", spec.name)._backend
            # the scan rows, or the validity stream and the codes
            arrs = ([b._C_all] if quant is None
                    else [b._adc_ok, *b.codes.arrays])
            return svc.submit(_request(api, query, spec.name)).ids, arrs

    want, ones = run()
    monkeypatch.setattr(mesh, "_real_devices", lambda device=None: [
        torch.device("cpu", 0), torch.device("cpu", 1)])
    got, twos = run()
    np.testing.assert_array_equal(got, want)
    assert len(ones) == len(twos) == {None: 1, "int8": 3, "pq8": 2}[quant]
    for one, two in zip(ones, twos):
        assert len(one.parts) == 1 and len(two.parts) == 2
        assert isinstance(two, RowSharded) and two.shape == one.shape
        for s in range(4):
            assert torch.equal(two.shard(s), one.shard(s))
