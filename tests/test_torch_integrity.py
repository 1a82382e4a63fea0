"""The page-checksum ledger, port against the JAX package.

* Checksums: the port's plain ``page_checksums`` (the kernel's twin) equals
  the reference's ``page_checksums`` and both packages'
  ``page_checksum_host`` on the same exported state, bit for bit: fp32
  and int8, hot and cold pages, pads, at one shard (a (1, 1) mesh) and
  four (the conftest ``mesh1d``).
* ``write_page``: the same page payloads written into both engines leave
  bitwise-equal states (export triple, scales, page checksums); page -1
  writes nothing.
* The binding's ledger after the same apply -> re-plan -> requant ->
  requant-demote sequence equals the reference's, and equals a full
  recompute after every step.  The histogram gives every page its own
  count, so the two planners (whose tie-breaks differ, ``ROADMAP.md``
  decisions of the second slice) pick the same hot set.
* ``export`` / ``load`` and ``fetch_snapshot_page`` across the two
  packages' snapshots (the same on-disk format).
* The ledger across a 4 -> 2 re-mesh: rebound, consistent, unflipped
  pages carried verbatim, and equal to the reference's on every page both
  packages keep in the same tier.

Checksums, states and ledgers compare bitwise (integers, or float bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import integrity as jinteg
from repro.core import updates as jupd
from repro.core.pifs import ServeBinding as JServeBinding
from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.distributed.sharding import make_mesh
from repro.serving import updates as jsupd

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import integrity as integ
from repro_torch.core import updates as upd
from repro_torch.core.paging import HOT_SHARD, PageTable
from repro_torch.core.pifs import ServeBinding, engine_for_tables
from repro_torch.kernels import ops
from repro_torch.serving.updates import StreamingUpdater

VOCABS, DIM, PAGE_BYTES, HOT = [300, 200], 16, 512, 0.2


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def _carried(storage, mesh):
    """A JAX engine on ``mesh`` with planner-placed hot pages and the port
    engine (n_shards = the mesh's tp) holding the same state."""
    n_shards = dict(mesh.shape)["model"]
    jeng, offs = jengine_for_tables(VOCABS, DIM, mesh, hot_fraction=HOT,
                                    page_bytes=PAGE_BYTES, storage=storage)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    with mesh:
        for _ in range(3):
            ids = np.stack([np.minimum(rng.zipf(1.3, (8, 5)) - 1, v - 1) + o
                            for v, o in zip(VOCABS, offs)], axis=1)
            jstate = jeng.observe(jstate, jnp.asarray(ids, jnp.int32))
        jstate, stats = jeng.plan_and_migrate(jstate)
    assert stats["hot_pages"] > 0
    eng, _ = engine_for_tables(VOCABS, DIM, device="cpu", hot_fraction=HOT,
                               page_bytes=PAGE_BYTES, storage=storage,
                               n_shards=n_shards)
    state = eng.pack_state(*map(np.asarray, jeng.export_state(jstate)),
                           table=_table(jstate),
                           counts=np.asarray(jstate.counts))
    return jeng, jstate, eng, state


def _table(jstate):
    return PageTable(np.asarray(jstate.page_to_shard),
                     np.asarray(jstate.page_to_slot))


def _pages(P):
    return np.concatenate([np.arange(P), [-1, 3, -1]]).astype(np.int32)


def _page_rows(eng, state, page):
    """A page's native rows and scale from the port state's tensors."""
    ps = eng.cfg.page_size
    shard = int(state.page_to_shard[page])
    first = int(state.page_to_slot[page]) * ps
    scale = float(state.page_scales[page])
    if shard == HOT_SHARD:
        return state.hot[first:first + ps].numpy(), scale
    first += shard * eng.cfg.rows_per_shard
    return state.cold[first:first + ps].numpy(), scale


def _u64(cs):
    cs = np.asarray(cs).astype(np.uint64)
    return (cs[:, 1] << np.uint64(32)) | cs[:, 0]


# ---------------------------------------------------------------------------
# The checksum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("meshname", ["mesh11", "mesh1d"])
def test_plain_checksums_match_reference_and_host_twins(storage, meshname,
                                                        request):
    mesh = request.getfixturevalue(meshname)
    jeng, jstate, eng, state = _carried(storage, mesh)
    P = eng.cfg.num_pages
    pages = _pages(P)
    with mesh:
        want = np.asarray(jeng.page_checksums(jstate, jnp.asarray(pages)))
    assert want.dtype == np.uint32
    got = eng.page_checksums(state, pages, impl="torch")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got[pages < 0].numpy(), 0)
    hot = state.page_to_shard.numpy() == HOT_SHARD
    assert hot.any() and (~hot).any()
    host = _u64(want[:P])
    for page in range(P):
        rows, scale = _page_rows(eng, state, page)
        assert rows.dtype == (np.float32 if hot[page] or storage == "fp32"
                              else np.int8)
        assert integ.page_checksum_host(rows, scale) == int(host[page])
        assert jinteg.page_checksum_host(rows, scale) == int(host[page])
    # the ledger's compute is the same fold, as uint64 (s2 << 32) | s1
    ledger = integ.PageChecksumLedger(eng, impl="torch")
    np.testing.assert_array_equal(ledger.compute(state, np.arange(P)), host)


def test_host_twin_matches_reference_on_edge_values():
    """NaN, infinities, -0.0, subnormals and all 256 int8 codes; and the
    position weight tells swapped rows apart."""
    rng = np.random.default_rng(0)
    f = rng.normal(size=(8, 16)).astype(np.float32)
    f.ravel()[:6] = [np.nan, np.inf, -np.inf, -0.0, 1e-45, -3e38]
    q = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    for rows, scale in ((f, 1.0), (q, 0.0123), (q, 0.0), (f, -2.5e-9)):
        assert (integ.page_checksum_host(rows, scale)
                == jinteg.page_checksum_host(rows, scale))
    swapped = f[[1, 0] + list(range(2, 8))]
    assert (integ.page_checksum_host(swapped, 1.0)
            != integ.page_checksum_host(f, 1.0))
    for mod in (integ, jinteg):
        with pytest.raises(TypeError, match="unsupported page dtype"):
            mod.page_checksum_host(f.astype(np.float64), 1.0)


# ---------------------------------------------------------------------------
# write_page
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("meshname", ["mesh11", "mesh1d"])
def test_write_page_matches_reference(storage, meshname, request):
    mesh = request.getfixturevalue(meshname)
    jeng, jstate, eng, state = _carried(storage, mesh)
    c = eng.cfg
    ps, P = c.page_size, c.num_pages
    rng = np.random.default_rng(5)
    p2s = state.page_to_shard.numpy()
    hot_page = int(np.nonzero(p2s == HOT_SHARD)[0][0])
    cold_page = int(np.nonzero(p2s == dict(mesh.shape)["model"] - 1)[0][-1])
    cdt = np.int8 if storage == "int8" else np.float32
    before = [x.clone() for x in (state.cold, state.hot, state.page_scales)]
    for page in (hot_page, cold_page, -1):
        if storage == "int8":
            crow = rng.integers(-127, 128, (ps, DIM)).astype(np.int8)
        else:
            crow = rng.normal(size=(ps, DIM)).astype(np.float32)
        hrow = rng.normal(size=(ps, DIM)).astype(np.float32)
        scale = float(rng.uniform(0.001, 0.02))
        with mesh:
            jstate = jeng.write_page(jstate, page, crow, hrow, scale)
        assert eng.write_page(state, page, crow, hrow, scale) is state
        if page == -1:
            continue
        rows, sc = _page_rows(eng, state, page)
        np.testing.assert_array_equal(
            rows, hrow if page == hot_page else crow.astype(cdt))
        assert np.float32(sc) == np.float32(scale)
    pages = np.arange(P, dtype=np.int32)
    with mesh:
        want = [np.asarray(x) for x in jeng.export_state(jstate)]
        jcs = np.asarray(jeng.page_checksums(jstate, jnp.asarray(pages)))
    for a, b in zip(eng.export_state(state), want):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(
        eng.page_checksums(state, pages, impl="torch").numpy(),
        jcs.astype(np.int64))
    # only the two pages changed
    changed = np.nonzero(~np.all(
        state.page_scales.numpy()[:, None] == before[2].numpy()[:, None],
        axis=1))[0]
    assert set(changed.tolist()) <= {hot_page, cold_page}
    with pytest.raises(ValueError, match="outside"):
        eng.write_page(state, P, crow, hrow, 1.0)


def test_write_page_pad_writes_nothing_and_counts_one_signature(mesh11):
    _, _, eng, state = _carried("int8", mesh11)
    keep = [x.clone() for x in (state.cold, state.hot, state.page_scales)]
    ps = eng.cfg.page_size
    eng.reset_plan_stats(clear_plans=True)
    for _ in range(3):
        eng.write_page(state, -1, np.ones((ps, DIM), np.int8),
                       np.ones((ps, DIM), np.float32), 5.0)
        eng.page_checksums(state, np.full(7, -1, np.int32), impl="torch")
        eng.page_checksums(state, np.arange(3, dtype=np.int32),
                           impl="torch")
    for a, b in zip((state.cold, state.hot, state.page_scales), keep):
        assert torch.equal(a, b)
    stats = eng.plan_stats()
    assert stats["traces"] == 2 and stats["calls"] == 9
    with pytest.raises(ValueError, match="page payloads"):
        eng.write_page(state, 0, np.ones((ps, DIM + 1), np.int8),
                       np.ones((ps, DIM), np.float32), 1.0)


# ---------------------------------------------------------------------------
# The binding's ledger under the mutation paths
# ---------------------------------------------------------------------------


def _distinct_counts_ids(P, ps, seed):
    """Ids giving page p a count of perm[p] + 1: every count distinct."""
    perm = np.random.default_rng(seed).permutation(P)
    ids = np.concatenate([p * ps + np.arange(perm[p] + 1) % ps
                          for p in range(P)])
    return ids.astype(np.int32)[None, None, :]


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_ledger_tracks_mutations_like_reference(storage, mesh11):
    jeng, jstate, eng, state = _carried(storage, mesh11)
    c = eng.cfg
    jb = JServeBinding(jeng, jstate, None, None)
    pb = ServeBinding(eng, state, None, None, impl="torch")
    with mesh11:
        jb.attach_integrity()
    pb.attach_integrity()

    def same(what):
        assert pb.integrity.checksums.dtype == np.uint64
        np.testing.assert_array_equal(pb.integrity.checksums,
                                      jb.integrity.checksums, err_msg=what)
        assert pb.integrity.verify(pb.state).size == 0, what
        np.testing.assert_array_equal(
            pb.state.page_to_shard.numpy() == HOT_SHARD,
            np.asarray(jb.state.page_to_shard) == HOT_SHARD, err_msg=what)

    same("build")
    rng = np.random.default_rng(2)
    rows = rng.integers(0, c.total_rows, 40)
    deltas = (rng.normal(size=(40, DIM)) * 0.05).astype(np.float32)
    with mesh11:
        jb.apply_deltas(rows, deltas)
    pb.apply_deltas(rows, deltas)
    same("apply")
    ids = _distinct_counts_ids(c.num_pages, c.page_size, 3)
    with mesh11:
        jb.observe({"indices": ids})
        jb.replan()
    pb.observe({"indices": ids})
    pb.replan()
    same("replan")
    hot = np.nonzero(pb.state.page_to_shard.numpy() == HOT_SHARD)[0]
    req = np.asarray([hot[0], -1, hot[-1]], np.int32)
    with mesh11:
        jb.requant_hot_pages(req)
    assert pb.requant_hot_pages(req) == 2
    same("requant")
    knobs = dict(capacity=32, drift_threshold=0.01, hotness_guard=0.0)
    jup = jsupd.StreamingUpdater(jb, [], jupd.UpdateConfig(**knobs))
    pup = StreamingUpdater(pb, [], upd.UpdateConfig(**knobs))
    hrows = (hot[:, None] * c.page_size + np.arange(2)).ravel()
    hd = np.full((hrows.size, DIM), 0.01, np.float32)
    jup.tracker.update(hrows, hd)
    pup.tracker.update(hrows, hd)
    with mesh11:
        jn = jup.requant_demote()
    assert pup.requant_demote() == jn > 0
    same("demote")
    full = integ.PageChecksumLedger.build(eng, pb.state, impl="torch")
    np.testing.assert_array_equal(full.checksums, pb.integrity.checksums)


def test_export_load_and_snapshot_pages_across_packages(mesh11, tmp_path):
    """The port's ledger exports the reference's dict; each package loads
    the other's; a snapshot of either package serves its pages (and the
    snapshot-time checksum) to both packages' ``fetch_snapshot_page``."""
    jeng, jstate, eng, state = _carried("int8", mesh11)
    jb = JServeBinding(jeng, jstate, None, None)
    pb = ServeBinding(eng, state, None, None, impl="torch")
    with mesh11:
        jb.attach_integrity()
        jb.attach_checkpointer(JCheckpointer(str(tmp_path / "j")))
    pb.attach_integrity()
    pb.attach_checkpointer(Checkpointer(str(tmp_path / "p")))
    data = pb.integrity.export()
    assert data == jb.integrity.export()
    fresh = integ.PageChecksumLedger(eng)
    fresh.load(jb.integrity.export())
    np.testing.assert_array_equal(fresh.checksums, pb.integrity.checksums)
    jfresh = jinteg.PageChecksumLedger(jeng)
    jfresh.load(data)
    np.testing.assert_array_equal(jfresh.checksums, fresh.checksums)
    with pytest.raises(ValueError, match="size mismatch"):
        fresh.load({"checksums": data["checksums"][:-1]})
    p2s = state.page_to_shard.numpy()
    pages = [int(np.nonzero(p2s == HOT_SHARD)[0][0]),
             int(np.nonzero(p2s != HOT_SHARD)[0][0])]
    readers = [(integ.fetch_snapshot_page, Checkpointer),
               (jinteg.fetch_snapshot_page, JCheckpointer)]
    for where in ("p", "j"):
        for fetch, ckpt in readers:
            for page in pages:
                for cfg in (eng.cfg, jeng.cfg):
                    snap = fetch(ckpt(str(tmp_path / where)), cfg, page)
                    rows, scale = _page_rows(eng, state, page)
                    np.testing.assert_array_equal(snap["rows"], rows)
                    assert snap["scale"] == scale
                    assert snap["tier"] == ("hot" if page == pages[0]
                                            else "cold")
                    assert snap["checksum"] == int(
                        pb.integrity.checksums[page])
                    assert integ.page_checksum_host(
                        snap["rows"], snap["scale"]) == snap["checksum"]


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_ledger_survives_remesh_4_to_2(storage, mesh1d):
    jeng, jstate, eng, state = _carried(storage, mesh1d)
    c = eng.cfg
    jb = JServeBinding(jeng, jstate, None, None)
    pb = ServeBinding(eng, state, None, None, impl="torch")
    jb.attach_remesher(lambda e, m: (None, None), prefer_tp=2)
    pb.attach_remesher(lambda e: (None, None), prefer_tp=2)
    with mesh1d:
        jb.attach_integrity()
    pb.attach_integrity()
    before = pb.integrity.checksums.copy()
    old_hot = pb.state.page_to_shard.numpy() == HOT_SHARD
    with mesh1d:
        jev = jb.remesh(lost_shard=3, batch_granule=8)
    ev = pb.remesh(lost_shard=3, batch_granule=8)
    assert ev == {**jev, "from_mesh": dict(jev["from_mesh"]),
                  "to_mesh": dict(jev["to_mesh"])}
    assert ev["to_mesh"] == {"data": 1, "model": 2}
    assert pb.engine.cfg.n_shards == 2 and pb.integrity.engine is pb.engine
    assert pb.integrity.verify(pb.state).size == 0
    new_hot = pb.state.page_to_shard.numpy() == HOT_SHARD
    kept = np.nonzero(old_hot == new_hot)[0]
    np.testing.assert_array_equal(pb.integrity.checksums[kept],
                                  before[kept])
    same_tier = new_hot == (np.asarray(jb.state.page_to_shard) == HOT_SHARD)
    np.testing.assert_array_equal(pb.integrity.checksums[same_tier],
                                  jb.integrity.checksums[same_tier])
    rng = np.random.default_rng(4)
    rows = rng.integers(0, c.total_rows, 24)
    pb.apply_deltas(rows, (rng.normal(size=(24, DIM)) * 0.01
                           ).astype(np.float32))
    assert pb.integrity.verify(pb.state).size == 0

    class _Geometry:
        class cfg:
            num_pages = c.num_pages + 1

    with pytest.raises(ValueError, match="page-geometry change"):
        pb.integrity.rebind(_Geometry())


@pytest.mark.cuda
def test_cuda_page_checksums_match_their_plain_version_on_the_card():
    """The kernel against its plain version and the host twin on the card:
    fp32 and int8, 1 and 4 shards, D = 16 (16-byte loads) and 18 (the
    scalar path), pads and an id past the end (chip_smoke.py runs whole
    RMC4 stores)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    rng = np.random.default_rng(0)
    for storage in ("fp32", "int8"):
        for S in (1, 4):
            for D in (16, 18):
                eng, _ = engine_for_tables([300, 200], D, device="cuda",
                                           hot_fraction=HOT,
                                           page_bytes=PAGE_BYTES,
                                           storage=storage, n_shards=S)
                st = eng.init_state(torch.Generator("cuda").manual_seed(0))
                P = eng.cfg.num_pages
                hot = rng.permutation(P)[:eng.cfg.hot_pages]
                st.page_to_shard[hot] = -1
                st.page_to_slot[hot] = torch.arange(
                    hot.size, device="cuda", dtype=torch.int32)
                st.hot.normal_()
                pages = torch.as_tensor(np.concatenate(
                    [np.arange(P), [-1, P + 5]]).astype(np.int32),
                    device="cuda")
                common = (st.cold, st.hot, st.page_scales, st.page_to_shard,
                          st.page_to_slot, pages, eng.cfg.page_size,
                          eng.cfg.rows_per_shard)
                got = ops.page_checksums(*common)
                want = ops.page_checksums(*common, impl="torch")
                torch.cuda.synchronize()
                assert torch.equal(got, want)
                cs = _u64(got.cpu().numpy())
                for page in range(P):
                    rows, scale = _page_rows(eng, _to_cpu(st), page)
                    assert integ.page_checksum_host(rows, scale) == cs[page]


def _to_cpu(st):
    import dataclasses
    return dataclasses.replace(st, **{f.name: getattr(st, f.name).cpu()
                                      for f in dataclasses.fields(st)})
