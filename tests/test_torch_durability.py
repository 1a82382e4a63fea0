"""Durability of streaming updates, port against the JAX package.

* The write-ahead log: the same appends give the same bytes in both
  packages, each replays the other's log, and a torn tail or a corrupt
  record behaves the same (a torn tail ends replay and is cut on open; a
  CRC mismatch in a complete record raises).
* Checkpoints: the same on-disk format, so a port snapshot restores into
  the reference engine and a reference snapshot into the port, leaves
  bitwise equal; the reference's guards (tree structure, dtype, shape,
  CRC) and partial reads.
* The binding's recovery seam: snapshot -> 3 applies -> the tiers
  overwritten -> ``restore`` (the checkpoint, then the WAL's suffix)
  reproduces the live state and scores bitwise, with ``update_seq`` 3 and
  no new signature.  The reference's
  ``tests/test_updates.py::test_binding_apply_logs_and_replay_restores_
  bitwise`` is among its ten known failures; this test holds the port to
  the same contract on its own values and copies none of that test's
  trace assertions.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.wal import WriteAheadLog as JWriteAheadLog
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.distributed.sharding import make_mesh
from repro.serving import loadgen as jloadgen

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.wal import WriteAheadLog
from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import PageTable
from repro_torch.core.pifs import EngineState, engine_for_tables
from repro_torch.serving import loadgen

VOCABS, DIM, PAGE_BYTES, HOT = [300, 200], 16, 512, 0.2
FIELDS = ("cold", "hot", "page_scales", "page_to_shard", "page_to_slot",
          "counts")
WALS = {"port": WriteAheadLog, "ref": JWriteAheadLog}


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def _records(rng, n=5, dim=DIM):
    out = []
    for seq in range(1, n + 1):
        k = int(rng.integers(0, 9))
        out.append((seq * 3, rng.integers(0, 1000, k).astype(np.int32),
                    rng.normal(size=(k, dim)).astype(np.float32)))
    return out


def _replay(wal):
    return [(s, r.copy(), d.copy()) for s, r, d in wal.replay()]


def _same_records(a, b):
    assert len(a) == len(b)
    for (s1, r1, d1), (s2, r2, d2) in zip(a, b):
        assert s1 == s2
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(d1, d2)
        assert r1.dtype == r2.dtype and d1.dtype == d2.dtype


# ---------------------------------------------------------------------------
# Write-ahead log
# ---------------------------------------------------------------------------


def test_wal_bytes_equal_and_each_replays_the_other(tmp_path):
    recs = _records(np.random.default_rng(0))
    wals = {k: cls(str(tmp_path / f"{k}.wal")) for k, cls in WALS.items()}
    for seq, rows, d in recs:
        for w in wals.values():
            w.append(seq, rows.astype(np.int64), d)   # any int dtype in
    assert ((tmp_path / "port.wal").read_bytes()
            == (tmp_path / "ref.wal").read_bytes())
    assert len(wals["port"]) == len(wals["ref"]) == len(recs)
    # each package opens and replays the other's file
    _same_records(_replay(WriteAheadLog(str(tmp_path / "ref.wal"))), recs)
    _same_records(_replay(JWriteAheadLog(str(tmp_path / "port.wal"))), recs)
    for w in wals.values():
        w.truncate()
    assert ((tmp_path / "port.wal").read_bytes()
            == (tmp_path / "ref.wal").read_bytes() == b"PIFSWAL1")
    assert len(wals["port"]) == 0 and _replay(wals["port"]) == []


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_wal_torn_tail_and_corruption_match_reference(writer, tmp_path):
    """Cut mid-record: both replay the complete records and stop; opening
    cuts the tail (same bytes), so a later append is replayed.  A flipped
    payload byte in a complete record raises IOError in both."""
    recs = _records(np.random.default_rng(1))
    path = str(tmp_path / "w.wal")
    w = WALS[writer](path)
    for seq, rows, d in recs:
        w.append(seq, rows, d)
    full = open(path, "rb").read()
    cut = full[:-7]
    for cls in WALS.values():
        open(path, "wb").write(cut)
        _same_records(_replay(_reader(cls, path)), recs[:-1])
    cuts = {}
    for name, cls in WALS.items():
        open(path, "wb").write(cut)
        wal = cls(path)                       # opening cuts the torn tail
        assert len(wal) == len(recs) - 1
        wal.append(99, np.asarray([7], np.int32),
                   np.ones((1, DIM), np.float32))
        cuts[name] = open(path, "rb").read()
        _same_records(_replay(wal), recs[:-1] + [
            (99, np.asarray([7], np.int32), np.ones((1, DIM), np.float32))])
    assert cuts["port"] == cuts["ref"]
    bad = bytearray(full)
    bad[8 + 20 + 2] ^= 0xFF                   # first record's payload
    for cls in WALS.values():
        open(path, "wb").write(bytes(bad))
        with pytest.raises(IOError, match="checksum"):
            cls(path)
        with pytest.raises(IOError, match="checksum"):
            _replay(_reader(cls, path))
        open(path, "wb").write(b"NOTAWAL!")
        with pytest.raises(IOError, match="magic"):
            cls(path)


def _reader(cls, path):
    """A log object over ``path`` that has not run its open-time repair
    (replay alone reads the file)."""
    wal = cls.__new__(cls)
    wal.path, wal.records = path, 0
    return wal


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _carried(storage, mesh):
    jeng, offs = jengine_for_tables(VOCABS, DIM, mesh, hot_fraction=HOT,
                                    page_bytes=PAGE_BYTES, storage=storage)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    with mesh:
        for _ in range(3):
            ids = np.stack([np.minimum(rng.zipf(1.3, (8, 5)) - 1, v - 1) + o
                            for v, o in zip(VOCABS, offs)], axis=1)
            jstate = jeng.observe(jstate, jnp.asarray(ids, jnp.int32))
        jstate, _ = jeng.plan_and_migrate(jstate)
    eng, _ = engine_for_tables(VOCABS, DIM, device="cpu", hot_fraction=HOT,
                               page_bytes=PAGE_BYTES, storage=storage,
                               n_shards=dict(mesh.shape)["model"])
    state = eng.pack_state(*map(np.asarray, jeng.export_state(jstate)),
                           table=PageTable(np.asarray(jstate.page_to_shard),
                                           np.asarray(jstate.page_to_slot)),
                           counts=np.asarray(jstate.counts))
    return jeng, jstate, eng, state


def _as_np(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("meshname", ["mesh11", "mesh1d"])
def test_checkpoints_restore_across_packages(storage, meshname, request,
                                             tmp_path):
    """A port snapshot restores into the reference engine's state and a
    reference snapshot into the port's (a new tree, and in place), leaves
    bitwise equal to what was saved; the manifests name the same leaves
    with the same shapes, dtypes and CRCs."""
    mesh = request.getfixturevalue(meshname)
    jeng, jstate, eng, state = _carried(storage, mesh)
    # port -> reference
    ck = Checkpointer(str(tmp_path / "p"))
    ck.save(7, state, extra={"update_seq": 4})
    ck.wait()
    jck = JCheckpointer(str(tmp_path / "p"))
    assert jck.latest_step() == 7 and jck.extra() == {"update_seq": 4}
    got = jck.restore(jstate)
    for f, want in _as_np(state).items():
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), want)
    # reference -> port
    jck2 = JCheckpointer(str(tmp_path / "j"))
    jck2.save(3, jstate, blocking=True, extra={"n_shards": 1})
    ck2 = Checkpointer(str(tmp_path / "j"))
    pm, jm = ck.manifest(), ck2.manifest()
    assert sorted(pm["leaves"]) == sorted(jm["leaves"]) == sorted(FIELDS)
    for k in FIELDS:
        for field in ("file", "shape", "dtype"):
            assert pm["leaves"][k][field] == jm["leaves"][k][field]
    assert pm["leaves"]["page_to_shard"]["crc"] == \
        jm["leaves"]["page_to_shard"]["crc"]
    fresh = ck2.restore(state)
    for f, want in _as_np(jstate).items():
        np.testing.assert_array_equal(getattr(fresh, f).numpy(), want)
    target = EngineState(**{f: getattr(state, f).clone() for f in FIELDS})
    ptrs = [getattr(target, f).data_ptr() for f in FIELDS]
    assert ck2.restore(target, into=True) is target
    assert [getattr(target, f).data_ptr() for f in FIELDS] == ptrs
    for f, want in _as_np(jstate).items():
        np.testing.assert_array_equal(getattr(target, f).numpy(), want)
    # partial reads agree with the reference's on the same files
    for key in ("cold", "page_scales"):
        np.testing.assert_array_equal(ck2.read_leaf(key),
                                      jck2.read_leaf(key))
        spans = [(0, 3), (5, 2)]
        for a, b in zip(ck2.read_pages(key, spans),
                        jck2.read_pages(key, spans)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ck2.read_page(key, 5, 2),
                                      jck2.read_page(key, 5, 2))


def test_checkpoint_guards_match_reference(mesh11, tmp_path):
    """A snapshot of an int8 engine refuses to load into an fp32 one
    (dtype), a missing leaf refuses (structure), a rotted leaf file fails
    its CRC, a read past a leaf's end raises: in both packages."""
    _, jstate8, _, state8 = _carried("int8", mesh11)
    _, jstate32, _, state32 = _carried("fp32", mesh11)
    Checkpointer(str(tmp_path / "c")).save(1, state8, blocking=True)
    cks = (Checkpointer(str(tmp_path / "c")),
           JCheckpointer(str(tmp_path / "c")))
    for ck, st8, st32 in zip(cks, (state8, jstate8), (state32, jstate32)):
        with pytest.raises(ValueError, match="dtype mismatch"):
            ck.restore(st32)
        with pytest.raises(ValueError, match="structure mismatch"):
            ck.restore({"cold": st8.cold})
        with pytest.raises(IndexError):
            ck.read_page("cold", 10 ** 6, 1)
        with pytest.raises(KeyError):
            ck.read_leaf("nope")
    meta = cks[0].manifest()["leaves"]["hot"]
    path = os.path.join(str(tmp_path / "c"), "step_000000000001",
                        meta["file"])
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0x01
    open(path, "wb").write(bytes(raw))
    for ck, st8 in zip(cks, (state8, jstate8)):
        with pytest.raises(IOError, match="checksum"):
            ck.restore(st8)
        with pytest.raises(IOError, match="checksum"):
            ck.read_leaf("hot")


def test_checkpointer_retention_and_consistent_cut(tmp_path):
    """``keep`` most recent steps stay, a ``.tmp`` is never listed, and the
    host copy is taken at ``save``: an in-place write right after does not
    reach the snapshot."""
    ck = Checkpointer(str(tmp_path), keep=2)
    t = {"a": torch.arange(6, dtype=torch.float32), "b": {"c": torch.ones(3)}}
    for step in (1, 2, 3):
        ck.save(step, t)
        t["a"] += 100.0                       # the engine writes in place
    ck.wait()
    os.makedirs(tmp_path / "step_000000000009.tmp")
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert sorted(ck.manifest()["leaves"]) == ["a", "b::c"]
    got = ck.restore(t, step=2)
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(6) + 100.0)
    assert JCheckpointer(str(tmp_path)).all_steps() == [2, 3]


# ---------------------------------------------------------------------------
# The binding's recovery seam
# ---------------------------------------------------------------------------


def _binding(storage, n_shards=1):
    cfg = reduced(get_config("rmc1"))
    b = loadgen.bind_model(cfg, "cpu", storage=storage, n_shards=n_shards)
    batch = {"dense": np.random.default_rng(3).normal(
                 size=(8, cfg.n_dense)).astype(np.float32),
             "indices": np.tile(np.arange(cfg.pooling, dtype=np.int32),
                                (8, cfg.n_tables, 1)),
             "weights": np.ones((8, cfg.n_tables, cfg.pooling), np.float32)}
    b.observe(batch)
    b.replan()
    return cfg, b, batch


def _corrupt(binding, seed):
    """Overwrite both tiers with garbage (NaN hot rows, random codes or
    values): what a restore must undo."""
    g = torch.Generator().manual_seed(seed)
    st = binding.state
    st.hot.fill_(float("nan"))
    if st.cold.dtype == torch.int8:
        st.cold.copy_(torch.randint(-127, 128, st.cold.shape, generator=g,
                                    dtype=torch.int8))
    else:
        st.cold.copy_(torch.randn(st.cold.shape, generator=g))


@pytest.mark.parametrize("storage,n_shards",
                         [("fp32", 1), ("int8", 1), ("int8", 4)])
def test_snapshot_apply_corrupt_restore_is_bitwise(storage, n_shards,
                                                   tmp_path):
    cfg, b, batch = _binding(storage, n_shards)
    wal = WriteAheadLog(str(tmp_path / "u.wal"))
    b.attach_wal(wal)
    b.attach_checkpointer(Checkpointer(str(tmp_path / "ck")))
    rng = np.random.default_rng(5)
    total = int(b.engine.cfg.total_rows)
    for _ in range(3):
        b.apply_deltas(rng.integers(0, total, 40),
                       rng.normal(size=(40, cfg.emb_dim)).astype(np.float32)
                       * 0.05)
    assert b.update_seq == 3 and len(wal) == 3
    want = {f: getattr(b.state, f).clone() for f in FIELDS}
    scores = b.execute(batch).clone()
    b.reset_plan_stats()
    _corrupt(b, seed=2)
    assert not torch.equal(b.state.cold, want["cold"])
    b.restore()                                   # checkpoint + WAL replay
    for f in FIELDS:
        assert torch.equal(getattr(b.state, f), want[f]), f
    assert torch.equal(b.execute(batch), scores)
    assert b.update_seq == 3 and b.restores == 1
    assert b.plan_stats()["traces"] == 0          # no new signature


def test_snapshot_truncates_wal_and_replay_skips_committed(tmp_path):
    cfg, b, _ = _binding("fp32")
    wal = WriteAheadLog(str(tmp_path / "u.wal"))
    b.attach_wal(wal)
    b.attach_checkpointer(Checkpointer(str(tmp_path / "ck")))
    rng = np.random.default_rng(9)
    total = int(b.engine.cfg.total_rows)
    b.apply_deltas(rng.integers(0, total, 8),
                   rng.normal(size=(8, cfg.emb_dim)).astype(np.float32))
    assert len(wal) == 1
    b.snapshot()                                  # commits seq 1, truncates
    assert len(wal) == 0 and b.checkpointer.extra()["update_seq"] == 1
    assert b.checkpointer.extra()["mesh"] == {"data": 1, "model": 1}
    b.apply_deltas(rng.integers(0, total, 8),
                   rng.normal(size=(8, cfg.emb_dim)).astype(np.float32))
    want = b.state.cold.clone()
    _corrupt(b, seed=1)
    b.restore()
    assert torch.equal(b.state.cold, want) and b.update_seq == 2


def test_restore_guards_and_cross_package_binding_restore(mesh11, tmp_path):
    """A snapshot from another shard count or storage refuses with the
    reference's reasons; a reference binding's snapshot restores into a
    port binding of the same config, its leaves bitwise, and its WAL's
    suffix replays through the port."""
    cfg, b, _ = _binding("int8")
    b.attach_checkpointer(Checkpointer(str(tmp_path / "ck")))
    _, b4, _ = _binding("int8", n_shards=4)
    b4.checkpointer = Checkpointer(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="n_shards=1"):
        b4.restore()
    _, b32, _ = _binding("fp32")
    b32.checkpointer = Checkpointer(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="storage='int8'"):
        b32.restore()
    # the reference's binding writes snapshot and WAL; the port restores
    jcfg = jreduced(jget_config("rmc1"))
    jb = jloadgen.bind_model(jcfg, mesh11, storage="int8")
    pb = loadgen.bind_model(cfg, "cpu", storage="int8")
    rng = np.random.default_rng(2)
    with mesh11:
        jb.attach_wal(JWriteAheadLog(str(tmp_path / "j.wal")))
        jb.attach_checkpointer(JCheckpointer(str(tmp_path / "jck")))
        for _ in range(2):
            jb.apply_deltas(rng.integers(0, int(jb.engine.cfg.total_rows), 30),
                            rng.normal(size=(30, cfg.emb_dim))
                            .astype(np.float32) * 0.05)
        jdense = np.asarray(jb.engine.to_dense(jb.state))
    pb.attach_wal(WriteAheadLog(str(tmp_path / "j.wal")))
    pb.checkpointer = Checkpointer(str(tmp_path / "jck"))
    pb.restore()
    assert pb.update_seq == 2
    np.testing.assert_array_equal(pb.engine.to_dense(pb.state).numpy(),
                                  jdense)
