"""Crash-safe ingestion in the port: WAL, background checkpoints,
recovery and the step runner (`repro_torch.resilience`), on the CPU, in
port form of tests/test_resilience.py (d 8), and against the JAX
package's `repro.resilience`.

Held exactly:
  * the WAL's framing, rotation, torn-tail and corruption rules, as in
    the JAX package;
  * WAL segment files written by either package are byte-identical for
    the same appends, and each package replays the other's log record
    for record (a torn tail written by one is dropped by the other);
  * recovery (checkpoint + WAL-tail replay) rebuilds the acknowledged
    state: `state_digest` equal to an oracle's, and — for the same
    operations, checkpoint and crash in both packages, flat / ivf /
    graph under the flush and continuous schedulers — equal to the JAX
    package's recovered digest, with equal checkpoint bytes and equal
    search ids;
  * the kill-restart sweep (random interleavings, a crash around a
    random fsync) loses no acknowledged write;
  * the runner, the watchdog and `sleep_on` run on the virtual clock.
"""

import os
import threading

import numpy as np
import pytest

from repro import resilience as JR
from repro.serving import runtime as jruntime
from repro_torch import resilience as R
from repro_torch.core import dcpe, ppanns
from repro_torch.serving.runtime import Collection, VirtualClock

D = 8
CPU = "cpu"


def _rows(rng, n):
    return rng.normal(size=(n, D)).astype(np.float32)


# ---------------------------------------------------------------------------
# WAL unit behaviour: framing, rotation, torn tails, truncation.
# ---------------------------------------------------------------------------

class TestWal:
    def test_append_replay_round_trip(self, tmp_path):
        w = R.WriteAheadLog(tmp_path)
        a = {"C_sap": np.arange(12, dtype=np.float32).reshape(3, 4),
             "C_dce": np.ones((3, 4, 2), np.float32)}
        assert w.append("insert", a) == 1
        assert w.append("delete", {"rows": np.array([1], np.int64)}) == 2
        assert w.append("compact") == 3
        w.close()
        w2 = R.WriteAheadLog(tmp_path)
        recs = list(w2.replay())
        assert [(r.seq, r.op) for r in recs] == \
            [(1, "insert"), (2, "delete"), (3, "compact")]
        np.testing.assert_array_equal(recs[0].arrays["C_sap"], a["C_sap"])
        np.testing.assert_array_equal(recs[0].arrays["C_dce"], a["C_dce"])
        assert w2.last_seq == 3          # appends continue the sequence
        assert w2.append("compact") == 4
        w2.close()

    def test_segment_rotation_and_replay_order(self, tmp_path):
        w = R.WriteAheadLog(tmp_path, segment_bytes=2048)
        for i in range(40):
            w.append("insert", {"C_sap": np.full((2, D), i, np.float32),
                                "C_dce": np.zeros((2, 4, 2), np.float32)})
        segs = sorted(p for p in os.listdir(tmp_path)
                      if p.endswith(".seg"))
        assert len(segs) > 1, "rotation never triggered"
        w.close()
        w2 = R.WriteAheadLog(tmp_path, segment_bytes=2048)
        assert [r.seq for r in w2.replay()] == list(range(1, 41))
        w2.close()

    def test_torn_tail_dropped_and_physically_truncated(self, tmp_path):
        w = R.WriteAheadLog(tmp_path)
        w.append("compact")
        w.append("compact")
        w.close()
        seg = sorted(tmp_path.glob("wal-*.seg"))[-1]
        good = seg.stat().st_size
        with open(seg, "ab") as f:       # simulate a torn final frame
            f.write(b"PWAL\x01\x02garbage")
        w2 = R.WriteAheadLog(tmp_path)
        assert [r.seq for r in w2.replay()] == [1, 2]
        assert seg.stat().st_size == good, "torn tail not truncated"
        assert w2.append("compact") == 3
        w2.close()

    def test_corruption_in_non_final_segment_raises(self, tmp_path):
        w = R.WriteAheadLog(tmp_path, segment_bytes=512)
        for _ in range(20):
            w.append("insert", {"C_sap": np.zeros((1, D), np.float32),
                                "C_dce": np.zeros((1, 4, 2), np.float32)})
        w.close()
        first = sorted(tmp_path.glob("wal-*.seg"))[0]
        raw = bytearray(first.read_bytes())
        raw[len(raw) // 2] ^= 0xFF       # flip a payload bit mid-segment
        first.write_bytes(bytes(raw))
        with pytest.raises(R.WalCorruptionError):
            list(R.WriteAheadLog(tmp_path, segment_bytes=512).replay())

    def test_truncate_through_drops_whole_prefix_segments(self, tmp_path):
        w = R.WriteAheadLog(tmp_path, segment_bytes=512)
        for _ in range(30):
            w.append("insert", {"C_sap": np.zeros((1, D), np.float32),
                                "C_dce": np.zeros((1, 4, 2), np.float32)})
        n_before = len(list(tmp_path.glob("wal-*.seg")))
        assert n_before > 2
        assert w.truncate_through(15) >= 1
        assert len(list(tmp_path.glob("wal-*.seg"))) < n_before
        seqs = [r.seq for r in w.replay()]
        assert seqs == list(range(seqs[0], 31)) and seqs[0] <= 16
        w.close()

    def test_replay_after_seq_skips_prefix(self, tmp_path):
        w = R.WriteAheadLog(tmp_path)
        for _ in range(5):
            w.append("compact")
        assert [r.seq for r in w.replay(after_seq=3)] == [4, 5]
        w.close()


# ---------------------------------------------------------------------------
# The two packages' logs: equal bytes, read across.
# ---------------------------------------------------------------------------

def _log_ops(mod, root, segment_bytes=1024):
    rng = np.random.default_rng(5)
    w = mod.WriteAheadLog(root, segment_bytes=segment_bytes)
    for i in range(12):
        if i % 4 == 3:
            w.append("delete", {"rows": np.array([i, i + 1], np.int64)})
        elif i % 5 == 4:
            w.append("compact")
        else:
            w.append("insert", {"C_sap": _rows(rng, 3),
                                "C_dce": rng.normal(size=(3, 4, 2))
                                .astype(np.float32)})
    w.close()


def _records(mod, root):
    w = mod.WriteAheadLog(root, segment_bytes=1024)
    recs = [(r.seq, r.op, {k: v.tobytes() for k, v in r.arrays.items()},
             r.meta) for r in w.replay()]
    w.close()
    return recs


def test_wal_frames_cross_read_both_ways(tmp_path):
    _log_ops(R, tmp_path / "torch")
    _log_ops(JR, tmp_path / "jax")
    mine = sorted((tmp_path / "torch").glob("wal-*.seg"))
    theirs = sorted((tmp_path / "jax").glob("wal-*.seg"))
    assert len(mine) > 1                     # rotation happened
    assert [p.name for p in mine] == [p.name for p in theirs]
    for a, b in zip(mine, theirs):
        assert a.read_bytes() == b.read_bytes()
    want = _records(JR, tmp_path / "jax")
    assert len(want) == 12
    assert _records(R, tmp_path / "jax") == want      # port reads jax
    assert _records(JR, tmp_path / "torch") == want   # jax reads port


def test_torn_tail_of_either_package_dropped_by_the_other(tmp_path):
    for writer, reader, tag in ((R, JR, "a"), (JR, R, "b")):
        root = tmp_path / tag
        w = writer.WriteAheadLog(root)
        w.append("compact")
        plan = writer.FaultPlan().crash_before_fsync(at_record=1)
        w.fault_hook = plan.wal_hook
        with pytest.raises(writer.SimulatedCrash):
            w.append("insert", {"C_sap": np.ones((2, D), np.float32),
                                "C_dce": np.ones((2, 4, 2), np.float32)})
        w.close()
        r = reader.WriteAheadLog(root)
        assert [x.seq for x in r.replay()] == [1]
        assert r.append("compact") == 2
        r.close()


# ---------------------------------------------------------------------------
# Collection + WAL + checkpoint integration.
# ---------------------------------------------------------------------------

def _fresh(seed=11, backend="flat", **kw):
    kw.setdefault("compact_every", 64)
    return Collection("t", "c", D, seed=seed, backend=backend, device=CPU,
                      **kw)


class TestRecovery:
    def test_wal_only_recovery_bit_identical(self, tmp_path):
        rng = np.random.default_rng(0)
        col = _fresh()
        wal = R.WriteAheadLog(tmp_path)
        R.attach_wal(col, wal)
        col.insert(_rows(rng, 40))
        col.delete([1, 7])
        col.compact()
        col.insert(_rows(rng, 10))
        dig = col.store.state_digest()
        wal.close()
        col.close()
        col2, rep = R.recover(lambda: _fresh(), wal_dir=tmp_path)
        assert not rep.had_checkpoint
        assert rep.n_replayed == 4
        assert col2.store.state_digest() == dig
        assert col2.telemetry.snapshot()["n_wal_replayed"] == 4
        col2.close()

    def test_checkpoint_plus_tail_replay(self, tmp_path):
        rng = np.random.default_rng(1)
        ck = tmp_path / "col.ppcol"
        wd = tmp_path / "wal"
        col = _fresh()
        wal = R.WriteAheadLog(wd)
        R.attach_wal(col, wal)
        col.insert(_rows(rng, 30))
        R.AsyncCheckpointer(col, ck).checkpoint()   # truncates the WAL
        col.insert(_rows(rng, 5))                   # tail beyond it
        col.delete([3])
        dig = col.store.state_digest()
        wal.close()
        col.close()
        col2, rep = R.recover(lambda: _fresh(), checkpoint_path=ck,
                              wal_dir=wd)
        assert rep.had_checkpoint and rep.checkpoint_seq == 1
        assert rep.n_replayed == 2                  # tail only
        assert col2.store.state_digest() == dig
        col2.close()

    def test_async_checkpoint_never_blocks_serving(self, tmp_path):
        rng = np.random.default_rng(2)
        col = _fresh()
        col.insert(_rows(rng, 64))
        u = col.new_user()
        cq, tq = u.encrypt_query(_rows(rng, 1)[0])
        want, _ = col.search_batch(cq[None], tq[None], 3)
        cp = R.AsyncCheckpointer(col, tmp_path / "c.ppcol")
        t = cp.trigger()
        assert isinstance(t, threading.Thread)
        got, _ = col.search_batch(cq[None], tq[None], 3)  # not blocked
        np.testing.assert_array_equal(want, got)
        cp.join()
        assert (tmp_path / "c.ppcol").exists()
        assert col.telemetry.snapshot()["n_checkpoints"] == 1
        col.close()

    def test_checkpoint_every_n_ops(self, tmp_path):
        rng = np.random.default_rng(3)
        col = _fresh()
        cp = R.AsyncCheckpointer(col, tmp_path / "c.ppcol",
                                 every_n_ops=10)
        col.insert(_rows(rng, 8))
        cp.note_ops(8)
        assert not (tmp_path / "c.ppcol").exists()
        col.insert(_rows(rng, 8))
        cp.note_ops(8)                  # crosses the threshold
        cp.join()
        assert (tmp_path / "c.ppcol").exists()
        col.close()

    @pytest.mark.parametrize("mode,survives", [
        ("crash_before_fsync", False), ("crash_after_fsync", True)])
    def test_crash_around_fsync(self, tmp_path, mode, survives):
        rng = np.random.default_rng(4)
        col = _fresh()
        wal = R.WriteAheadLog(tmp_path)
        R.attach_wal(col, wal)
        plan = R.FaultPlan()
        getattr(plan, mode)(at_record=2)
        plan.install(col)
        col.insert(_rows(rng, 20))                  # record 1: acked
        with pytest.raises(R.SimulatedCrash):
            col.insert(_rows(rng, 6))               # record 2: crash
        col.close()
        col2, rep = R.recover(lambda: _fresh(), wal_dir=tmp_path)
        assert col2.store.n_total == (26 if survives else 20)
        assert rep.n_replayed == (2 if survives else 1)
        col2.close()


# ---------------------------------------------------------------------------
# The same crash and recovery in both packages.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rows():
    """Numpy-encrypted rows and queries (the JAX package's encryptors,
    copied), the keyless inputs of both packages."""
    rng = np.random.default_rng(9)
    P = _rows(rng, 120)
    owner = ppanns.DataOwner(d=D, sap_beta=dcpe.suggest_beta(P, 0.05),
                             seed=4)
    db = owner.encrypt_database(P, build_index=False)
    user = ppanns.User(owner.share_keys())
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in P[:3])))
    return db.C_sap, db.C_dce, Q, T


def _crash_and_recover(mod, Coll, kw, root, backend, sched, rows):
    """One op script with a checkpoint in the middle and a crash before
    the fsync of WAL record 6, then `recover`.  -> (recovered digest,
    the acknowledged ops' digest, RecoveryReport, checkpoint bytes, ids
    of a search after recovery)."""
    C_sap, C_dce, Q, T = rows

    def fresh():
        return Coll("t", "c", D, keyless=True, seed=7, backend=backend,
                    scheduler=sched, max_wait_ms=0.5, compact_every=48,
                    **kw)

    script = [("insert", slice(0, 40)), ("delete", [1, 7]),
              ("compact", None), ("insert", slice(40, 60)),
              ("checkpoint", None), ("insert", slice(60, 70)),
              ("delete", [3, 45]), ("insert", slice(70, 80))]
    col = fresh()
    wal = mod.WriteAheadLog(root / "wal")
    mod.attach_wal(col, wal)
    cp = mod.AsyncCheckpointer(col, root / "col.ppcol")
    plan = mod.FaultPlan().crash_before_fsync(at_record=6)
    plan.install(col)
    oracle = fresh()
    crashed = False
    for op, arg in script:
        try:
            if op == "insert":
                col.insert_encrypted(C_sap[arg], C_dce[arg])
            elif op == "delete":
                col.delete(arg)
            elif op == "compact":
                col.compact()
            else:
                cp.checkpoint()
                continue
        except mod.SimulatedCrash:
            crashed = True
            break
        if op == "insert":                   # acked: the oracle too
            oracle.insert_encrypted(C_sap[arg], C_dce[arg])
        elif op == "delete":
            oracle.delete(arg)
        else:
            oracle.compact()
    assert crashed
    col.close()
    acked = oracle.store.state_digest()
    oracle.close()
    col2, rep = mod.recover(fresh, checkpoint_path=root / "col.ppcol",
                            wal_dir=root / "wal")
    try:
        ids = np.asarray(col2.search_batch(Q, T, 5)[0])
        digest = col2.store.state_digest()
    finally:
        col2.close()
    return digest, acked, rep, (root / "col.ppcol").read_bytes(), ids


@pytest.mark.parametrize("sched", ["flush", "continuous"])
@pytest.mark.parametrize("backend", ["flat", "ivf", "graph"])
def test_recovered_state_matches_the_jax_package(tmp_path, rows, backend,
                                                 sched):
    got = _crash_and_recover(R, Collection, {"device": CPU},
                             tmp_path / "torch", backend, sched, rows)
    want = _crash_and_recover(JR, jruntime.Collection, {},
                              tmp_path / "jax", backend, sched, rows)
    digest, acked, rep, ckpt, ids = got
    assert digest == acked, "acknowledged-write loss"
    assert digest == want[0]
    assert (rep.had_checkpoint, rep.checkpoint_seq, rep.n_replayed,
            rep.n_rows_replayed, rep.last_seq) == \
        (want[2].had_checkpoint, want[2].checkpoint_seq,
         want[2].n_replayed, want[2].n_rows_replayed, want[2].last_seq)
    assert rep.had_checkpoint and rep.n_replayed == 1
    assert ckpt == want[3], "checkpoint blobs differ"
    np.testing.assert_array_equal(ids, want[4])


# ---------------------------------------------------------------------------
# Seeded kill-restart durability sweep.
# ---------------------------------------------------------------------------

def _apply_ops(col, ops):
    for op, arg in ops:
        if op == "insert":
            col.insert_encrypted(*arg)
        elif op == "delete":
            col.delete(arg)
        elif op == "compact":
            col.compact()


@pytest.mark.parametrize("backend", ["flat", "ivf", "graph"])
@pytest.mark.parametrize("sched", ["flush", "continuous"])
def test_kill_restart_sweep(tmp_path, backend, sched):
    seed0 = {"flat": 100, "ivf": 200, "graph": 300}[backend]
    for case in range(2):
        seed = seed0 + case
        rng = np.random.default_rng(seed)
        base = tmp_path / f"case{case}"
        wd, ck = base / "wal", base / "col.ppcol"

        def fresh():
            return _fresh(seed=7, backend=backend, scheduler=sched,
                          max_wait_ms=0.5, compact_every=48)

        col = fresh()
        wal = R.WriteAheadLog(wd)
        R.attach_wal(col, wal)
        owner = col.owner
        cp = R.AsyncCheckpointer(col, ck)
        n_ops = int(rng.integers(6, 12))
        crash_at = int(rng.integers(2, n_ops + 1))
        mode = ("crash_before_fsync", "crash_after_fsync")[
            int(rng.integers(2))]
        plan = R.FaultPlan()
        getattr(plan, mode)(at_record=crash_at)
        plan.install(col)

        applied, crashed_op = [], None
        for _ in range(n_ops + 3):       # a few extra: crash must land
            r = rng.random()
            if r < 0.55 or col.store.n_alive < 4:
                enc = owner.encrypt_vectors(
                    _rows(rng, int(rng.integers(4, 16))), device=CPU)
                op = ("insert", enc)
            elif r < 0.75:
                alive = np.flatnonzero(col.store.alive_view)
                pick = rng.choice(alive, size=min(2, alive.size),
                                  replace=False)
                op = ("delete", sorted(int(x) for x in pick))
            elif r < 0.9:
                op = ("compact", None)
            else:
                cp.checkpoint()          # durable; not a WAL op
                continue
            try:
                _apply_ops(col, [op])
                applied.append(op)       # acked
            except R.SimulatedCrash:
                crashed_op = op
                break
        assert crashed_op is not None, "crash never landed"
        col.close()

        col2, rep = R.recover(
            fresh, checkpoint_path=ck if ck.exists() else None,
            wal_dir=wd)
        oracle = fresh()
        expect = applied + ([crashed_op]
                            if mode == "crash_after_fsync" else [])
        _apply_ops(oracle, expect)
        assert col2.store.state_digest() == oracle.store.state_digest(), \
            f"seed {seed}: acknowledged-write loss ({mode})"
        user = oracle.new_user()
        for qi in range(3):
            cq, tq = user.encrypt_query(_rows(rng, 1)[0])
            np.testing.assert_array_equal(
                col2.search(cq, tq, 5), oracle.search(cq, tq, 5),
                err_msg=f"seed {seed} query {qi} diverged after recovery")
        col2.close()
        oracle.close()


# ---------------------------------------------------------------------------
# The clock-seam runner (and the `ft` alias package).
# ---------------------------------------------------------------------------

class TestRunnerPort:
    def test_ft_shim_warns_and_reexports(self):
        import importlib
        import repro_torch.ft.runner as shim
        with pytest.warns(DeprecationWarning):
            importlib.reload(shim)
        assert shim.ResilientRunner is R.ResilientRunner
        assert shim.RetryPolicy is R.RetryPolicy
        from repro_torch.ft import StragglerWatchdog
        assert StragglerWatchdog is R.StragglerWatchdog
        assert R.EngineRetryPolicy is not None

    def test_backoff_runs_on_virtual_clock(self):
        clock = VirtualClock()
        calls = {"n": 0}
        ckpt = {"step": 0, "state": 0}

        def step(state, batch):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("transient")
            return state + batch, {"loss": 0.0}

        runner = R.ResilientRunner(
            step,
            save_fn=lambda s, st: ckpt.update(step=s, state=st),
            restore_fn=lambda: (ckpt["step"], ckpt["state"]),
            policy=R.RetryPolicy(max_restarts=2, backoff_s=5.0),
            checkpoint_every=2, clock=clock)
        done = {}

        def drive():
            done["out"] = runner.run(0, 0, 6, get_batch=lambda s: 1)

        t = threading.Thread(target=drive)
        t.start()
        clock.wait_for_waiters(1)        # runner parked in backoff
        clock.advance(5.0)
        t.join(timeout=10)
        assert not t.is_alive()
        state, step_n, _ = done["out"]
        assert (state, step_n) == (6, 6)
        assert runner.restarts == 1

    def test_straggler_watchdog_redispatches_on_virtual_clock(self):
        clock = VirtualClock()
        wd = R.StragglerWatchdog(factor=3.0, clock=clock)
        for _ in range(8):
            wd.observe(0.01)

        def slow():
            clock.advance(1.0)          # a shard 100x the median
            return "slow"

        out = wd.run_sharded([lambda: "ok", slow, lambda: "ok"],
                             fallback_fn=lambda i: f"backup{i}")
        assert out == ["ok", "backup1", "ok"]
        assert wd.redispatches == 1

    def test_sleep_on_virtual_clock(self):
        clock = VirtualClock()
        woke = threading.Event()

        def sleeper():
            R.sleep_on(clock, 2.0)
            woke.set()

        t = threading.Thread(target=sleeper)
        t.start()
        clock.wait_for_waiters(1)
        assert not woke.is_set()
        clock.advance(2.0)
        t.join(timeout=10)
        assert woke.is_set()
