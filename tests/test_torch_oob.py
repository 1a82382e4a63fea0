"""Out-of-range and negative ids, and the beacon CLI, against the reference.

The reference engine serves any id: its page-table lookups are XLA
gathers, which wrap a negative page once and clamp what is still out of
range, so an id past the end reads a row of the last page and nothing
raises (``repro/core/pifs.py`` ``validate_ids`` docstring).  Its
histogram update is a scatter, which wraps a negative page once and drops
what is still out of range.  The port's ``_address`` and ``observe`` must
do the same (``repro_torch/core/pifs.py``), on every path that addresses
through ``_address``: split and fused (``fused_tp`` at 4 shards), pifs
and pond, dedup off and on.

Both engines hold the same state (``export_state`` -> ``pack_state``), as
``tests/test_torch_engine.py`` builds them: 2 tables of 300 and 200 rows,
D = 16, 512-byte pages, a hot tier of 20 % placed by the reference's
planner; 1 shard on a 1x1 mesh, 4 shards on the conftest ``mesh1d``.

Tolerance: none.  At 0/1 weights every product is exact, so lookups are
bitwise equal to the reference's; the port's interaction outputs are
compared bitwise with the port's own interaction of the reference's
pooled features (fused == split inside the port).

The kernel entries of ``kernels/ops.py`` read an id as
``ref.clamp_rows`` names it: clamped into [-V, V-1], then taken mod V,
V the rows of the table the entry reads (each tier apart; one slice per
shard of the S-slice partial pool; the whole cold tier for a gather-once
plan).  That is the row the reference's Pallas route (``impl="pallas"``,
interpret mode) reads for every id; its ``impl="jnp"`` oracles give NaN
rows instead, so the entries are held to the Pallas route, bitwise at
0/1 weights.  Tables, x and scales there are small integers and powers
of two, so every pooled value and every dot is exact and the fused
entries' interaction is bitwise too, whatever order each package sums
in.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sls as jsls
from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.distributed.sharding import make_mesh
from repro.kernels import ops as jops
from repro.launch import serve as jserve

from repro_torch.core import sls as core_sls
from repro_torch.core.paging import HOT_SHARD, PageTable
from repro_torch.core.pifs import engine_for_tables
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as srv

VOCABS, DIM, PAGE_BYTES, HOT = [300, 200], 16, 512, 0.2
B, L = 4, 5


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def _oob_ids(padded_rows: int):
    """The ids under test: past the end (the first, far, and the
    ``corrupt_oob`` fault's 2**31 - 2), and negative (one wrap lands in
    the table, or not)."""
    return [padded_rows, padded_rows + 1000, 2 ** 31 - 2,
            -1, -padded_rows, -padded_rows - 5]


def _carried(storage, mesh, n_shards):
    jeng, offs = jengine_for_tables(VOCABS, DIM, mesh, hot_fraction=HOT,
                                    page_bytes=PAGE_BYTES, storage=storage)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    for _ in range(3):
        jstate = jeng.observe(jstate, jnp.asarray(_ids(rng, offs)))
    jstate, _ = jeng.plan_and_migrate(jstate)
    eng, _ = engine_for_tables(VOCABS, DIM, device="cpu", hot_fraction=HOT,
                               page_bytes=PAGE_BYTES, storage=storage,
                               n_shards=n_shards)
    assert eng.cfg.padded_rows == jeng.cfg.padded_rows
    state = eng.pack_state(*map(np.asarray, jeng.export_state(jstate)),
                           table=PageTable(np.asarray(jstate.page_to_shard),
                                           np.asarray(jstate.page_to_slot)))
    return jeng, jstate, eng, state, offs, rng


def _ids(rng, offs):
    cols = [np.minimum(rng.zipf(1.3, (B, L)) - 1, v - 1) + o
            for v, o in zip(VOCABS, offs)]
    return np.stack(cols, axis=1).astype(np.int32)


def _oob_batch(rng, offs, padded_rows):
    """A (B, G, L) batch with every id under test in it (on both tables'
    bags, owned and hot neighbours alike), 0/1 weights with the test ids
    weighted 1, and x."""
    idx = _ids(rng, offs)
    w = (rng.random(idx.shape) < 0.8).astype(np.float32)
    flat_i, flat_w = idx.reshape(-1), w.reshape(-1)
    pos = rng.choice(idx.size, size=2 * len(_oob_ids(padded_rows)),
                     replace=False)
    flat_i[pos] = np.tile(np.asarray(_oob_ids(padded_rows), np.int64),
                          2).astype(np.int32)
    flat_w[pos] = 1.0
    x = rng.normal(size=(B, DIM)).astype(np.float32)
    return idx, w, x


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_oob_ids_serve_the_reference_rows(storage, n_shards, mesh11,
                                          request):
    """Lookups with out-of-range and negative ids equal the reference's
    bitwise (pifs and pond, dedup off and on); lookup_interact, split and
    fused, equals the port's interaction of the reference's features."""
    mesh = mesh11 if n_shards == 1 else request.getfixturevalue("mesh1d")
    jeng, jstate, eng, state, offs, rng = _carried(storage, mesh, n_shards)
    idx, w, x = _oob_batch(rng, offs, eng.cfg.padded_rows)
    ti, tw, tx = map(torch.as_tensor, (idx, w, x))
    for mode in ("pifs", "pond"):
        want = np.asarray(jeng.lookup(jstate, jnp.asarray(idx),
                                      jnp.asarray(w), mode=mode))
        assert np.isfinite(want).all()
        for dedup in ("off", "on"):
            got = eng.lookup(state, ti, tw, mode=mode, dedup=dedup)
            np.testing.assert_array_equal(got.numpy(), want,
                                          f"{mode} dedup={dedup}")
        feats = torch.cat([tx[:, None], torch.as_tensor(want.copy())], 1)
        inter = ops.dot_interaction(feats)
        for fe in ("split", "fused"):
            for dedup in ("off", "on"):
                got = eng.lookup_interact(state, ti, tx, tw, mode=mode,
                                          front_end=fe, dedup=dedup)
                if mode == "pond" and fe == "split":
                    # pond split pools after the shard sum (another order)
                    np.testing.assert_allclose(got.numpy(), inter.numpy(),
                                               rtol=1e-5, atol=1e-6)
                else:
                    np.testing.assert_array_equal(
                        got.numpy(), inter.numpy(),
                        f"{mode} {fe} dedup={dedup}")


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_oob_ids_one_id_bags_read_the_clamped_row(storage, mesh11):
    """A bag holding one test id reads exactly the dense table's row the
    reference's rule names: the page wrapped once if negative, then
    clamped; the offset ``id % page_size``."""
    jeng, jstate, eng, state, _, _ = _carried(storage, mesh11, 1)
    c = eng.cfg
    ids = np.asarray(_oob_ids(c.padded_rows), np.int64)
    idx = ids.astype(np.int32).reshape(-1, 1, 1)
    got = eng.lookup(state, torch.as_tensor(idx))[:, 0]
    want = np.asarray(jeng.lookup(jstate, jnp.asarray(idx)))[:, 0]
    np.testing.assert_array_equal(got.numpy(), want)
    page = ids // c.page_size
    page = np.clip(np.where(page < 0, page + c.num_pages, page), 0,
                   c.num_pages - 1)
    dense = eng.to_dense(state).numpy()
    np.testing.assert_array_equal(got.numpy(),
                                  dense[page * c.page_size + ids % c.page_size])


@pytest.mark.parametrize("weighted", [False, True])
def test_observe_counts_negative_and_oob_ids_as_the_reference(weighted,
                                                              mesh11):
    """observe's histogram equals the reference's: a negative page wraps
    once, what is still outside the table is dropped, weight-0 entries
    count nothing."""
    jeng, jstate, eng, state, offs, rng = _carried("fp32", mesh11, 1)
    c = eng.cfg
    idx = _ids(rng, offs)
    flat = idx.reshape(-1)
    extra = _oob_ids(c.padded_rows) + [-1 - c.page_size, -c.padded_rows + 1]
    flat[:len(extra)] = np.asarray(extra, np.int64).astype(np.int32)
    w = (rng.random(idx.shape) < 0.7).astype(np.float32)
    w.reshape(-1)[:len(extra)] = 1.0
    args = (idx, w) if weighted else (idx,)
    got = eng.observe(state, *map(torch.as_tensor, args))
    want = jeng.observe(jstate, *map(jnp.asarray, args))
    # pack_state starts the port's histogram at zero: compare the batch's
    # increments
    inc = (got.counts - state.counts).numpy()
    np.testing.assert_array_equal(
        inc, np.asarray(want.counts) - np.asarray(jstate.counts))
    # the last page counted the wrapped -1
    assert inc[c.num_pages - 1] >= 1


def test_beacon_cli_builds_a_hot_tier_as_the_reference(monkeypatch):
    """``--mode beacon`` binds the same hot tier as every mode
    (hot_fraction 0.05, placed from the profile), as the reference CLI
    does, and serves finite scores."""
    ref_default = inspect.signature(
        jserve.serve_offered_load).parameters["hot_fraction"].default
    assert ref_default == 0.05
    bound = []
    real_bind = srv.bind_model

    def spy(*a, **kw):
        b = real_bind(*a, **kw)
        bound.append((kw, b))
        return b

    monkeypatch.setattr(srv, "bind_model", spy)
    out = srv.main(["--device", "cpu", "--mode", "beacon", "--requests",
                    "24", "--batcher", "fixed", "--batch-sizes", "8"])
    assert out["scores_finite"] and out["batches"] == 3
    (kw, b), = bound
    assert kw["hot_fraction"] == ref_default
    assert b.engine.cfg.hot_pages > 0
    assert bool((b.state.page_to_shard == HOT_SHARD).any())


# -- the kernel entries of kernels/ops.py, direct (not through the engine) --

KB, KG, KL, KD = 4, 3, 5, 16       # fused shapes: (B, G, L) bags, width D
VC, VH, S4 = 40, 23, 4             # cold rows (S4 slices of 10), hot rows


def kernel_oob_ids(V: int) -> list:
    """The ids under test for a V-row table: past the end (the first, and
    far), negative (one wrap lands in the table, or not), the int32
    limits."""
    return [V, V + 93, -1, -V, -V - 1, -100, 2 ** 31 - 1, -2 ** 31]


def _rows_read(ids, V: int) -> np.ndarray:
    """The rule, in numpy: clamp into [-V, V-1], then mod V."""
    return np.remainder(np.clip(np.asarray(ids, np.int64), -V, V - 1), V)


def _plant(rng, ids: np.ndarray, where: np.ndarray, test_ids) -> None:
    """Put every test id (twice where room allows) at random positions
    of ``ids`` where ``where`` holds."""
    pos = np.flatnonzero(where.reshape(-1))
    k = min(pos.size, 2 * len(test_ids))
    pick = rng.choice(pos, size=k, replace=False)
    ids.reshape(-1)[pick] = np.resize(np.asarray(test_ids, np.int64),
                                      k).astype(np.int32)


def _exact_table(rng, V, storage):
    """Small integers (int8 codes within +-15), so that pooled values and
    their dots stay exact in float32."""
    if storage == "int8":
        return rng.integers(-15, 16, (V, KD)).astype(np.int8)
    return rng.integers(-3, 4, (V, KD)).astype(np.float32)


def _exact_scales(rng, shape, storage):
    return (np.exp2(-rng.integers(2, 4, shape)).astype(np.float32)
            if storage == "int8" else None)


def _sls_inputs(seed, storage, N=12, L=KL, V=VH):
    """(N, L) bags over a V-row table with every test id on owned and on
    masked entries, 0/1 weights (the test ids weighted 1)."""
    rng = np.random.default_rng(seed)
    table = _exact_table(rng, V, storage)
    idx = rng.integers(0, V, (N, L)).astype(np.int32)
    owned = rng.random((N, L)) < 0.7
    _plant(rng, idx, owned, kernel_oob_ids(V))
    _plant(rng, idx, ~owned, kernel_oob_ids(V))
    w = (rng.random((N, L)) < 0.8).astype(np.float32)
    w[(idx < 0) | (idx >= V)] = 1.0
    return table, idx, owned, w, _exact_scales(rng, (N, L), storage)


def _fe_inputs(seed, storage, S=1):
    """(B, G, L) entries of two tiers (cold: S slices of VC / S rows; hot:
    VH rows) and of neither, the test ids of each tier's V on its own
    entries and on entries of neither, an owner shard per cold entry."""
    rng = np.random.default_rng(seed)
    R = VC // S
    cold = _exact_table(rng, VC, storage)
    hot = _exact_table(rng, VH, "fp32")
    x = rng.integers(-3, 4, (KB, KD)).astype(np.float32)
    shape = (KB, KG, KL)
    rows = rng.integers(0, min(R, VH), shape).astype(np.int32)
    kind = rng.choice(3, size=shape, p=[0.5, 0.35, 0.15])   # cold/hot/none
    _plant(rng, rows, kind == 0, kernel_oob_ids(R))
    _plant(rng, rows, kind == 1, kernel_oob_ids(VH))
    _plant(rng, rows, kind == 2, kernel_oob_ids(R) + kernel_oob_ids(VH))
    owner = rng.integers(0, S, shape)
    owned = (kind == 0)[None] & (owner[None] == np.arange(S).reshape(
        S, 1, 1, 1))
    is_hot = kind == 1
    w = (rng.random(shape) < 0.8).astype(np.float32)
    w[(rows < 0) | (rows >= min(R, VH))] = 1.0
    # int8: one scale per cold row (as pages carry them), so that the
    # duplicates a gather-once plan merges share theirs
    row_scale = _exact_scales(rng, (VC,), storage)
    scales = (None if row_scale is None
              else row_scale[owner * R + _rows_read(rows, R)])
    return cold, hot, x, rows, owned, is_hot, w, scales


def _np(x):
    return np.asarray(x)


def _tt(x):
    return None if x is None else torch.as_tensor(x)


def _jj(x):
    return None if x is None else jnp.asarray(x)


def _equal(got, want, what):
    got, want = _np(got), _np(want)
    assert np.isfinite(want).all(), what
    np.testing.assert_array_equal(got, want, what)


@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_oob_sls_reads_the_pallas_rows(weighted):
    """``ops.sls`` on out-of-range and negative ids equals the reference's
    ``sls`` (Pallas route) bitwise, and a one-id bag reads row
    ``clamp_rows(id)``."""
    table, idx, _, w, _ = _sls_inputs(1, "fp32")
    wt = w if weighted else None
    got = ops.sls(_tt(table), _tt(idx), _tt(wt))
    want = jops.sls(_jj(table), _jj(idx), _jj(wt), impl="pallas",
                    interpret=True)
    _equal(got, want, "sls")
    one = np.asarray(kernel_oob_ids(VH), np.int64).astype(np.int32)[:, None]
    np.testing.assert_array_equal(ops.sls(_tt(table), _tt(one)).numpy(),
                                  table[_rows_read(one[:, 0], VH)])


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_kernel_oob_masked_sls_reads_the_pallas_rows(storage):
    """``ops.masked_sls`` (int8 with per-entry scales) on out-of-range and
    negative ids, owned and masked, equals the reference's Pallas
    ``masked_sls`` bitwise; with no mask it is ``ops.sls``'s rule too."""
    table, idx, owned, w, scales = _sls_inputs(2, storage)
    got = ops.masked_sls(_tt(table), _tt(idx), _tt(owned), _tt(w),
                         _tt(scales))
    want = jops.masked_sls(_jj(table), _jj(idx), _jj(owned), _jj(w),
                           impl="pallas", interpret=True,
                           scales=_jj(scales))
    _equal(got, want, f"masked_sls {storage}")
    every = np.ones_like(owned)
    got = ops.masked_sls(_tt(table), _tt(idx), None, _tt(w), _tt(scales))
    want = jops.masked_sls(_jj(table), _jj(idx), _jj(every), _jj(w),
                           impl="pallas", interpret=True,
                           scales=_jj(scales))
    _equal(got, want, f"masked_sls owned=None {storage}")


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_kernel_oob_masked_sls_dedup_reads_the_pallas_rows(storage):
    """``ops.masked_sls_dedup`` through the port's plan equals the
    reference's Pallas ``masked_sls_dedup`` through its own plan
    bitwise."""
    table, idx, owned, w, scales = _sls_inputs(3, storage)
    plan = core_sls.dedup_plan(_tt(idx), _tt(owned), _tt(scales))
    got = ops.masked_sls_dedup(_tt(table), plan, _tt(owned), _tt(w))
    jplan = jsls.dedup_plan(_jj(idx), _jj(owned), _jj(scales))
    want = jops.masked_sls_dedup(_jj(table), jplan, _jj(owned), _jj(w),
                                 impl="pallas", interpret=True)
    _equal(got, want, f"masked_sls_dedup {storage}")


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_kernel_oob_fused_front_end_reads_the_pallas_rows(storage, dedup):
    """``ops.fused_front_end`` and ``ops.fused_front_end_dedup`` with test
    ids of each tier's own V in both tiers (and on entries of neither)
    equal the reference's Pallas fused front end bitwise (exact data:
    the interaction too)."""
    cold, hot, x, rows, owned, is_hot, w, scales = _fe_inputs(4, storage)
    own = owned[0]
    args = (cold, hot, x, rows, own, is_hot, w)
    jplans = None
    if dedup:
        nb = KB * KG
        flat = _tt(rows.reshape(nb, KL))
        s2 = None if scales is None else _tt(scales.reshape(nb, KL))
        cp = core_sls.dedup_plan(flat, _tt(own.reshape(nb, KL)), s2)
        hp = core_sls.dedup_plan(flat, _tt(is_hot.reshape(nb, KL)))
        got = ops.fused_front_end_dedup(
            *map(_tt, args[:3]),
            cp._replace(slots=cp.slots.reshape(rows.shape)),
            hp._replace(slots=hp.slots.reshape(rows.shape)),
            _tt(own), _tt(is_hot), _tt(w))
        jflat = _jj(rows.reshape(nb, KL))
        jcp = jsls.dedup_plan(jflat, _jj(own.reshape(nb, KL)),
                              None if scales is None
                              else _jj(scales.reshape(nb, KL)))
        jhp = jsls.dedup_plan(jflat, _jj(is_hot.reshape(nb, KL)))
        jplans = (jcp._replace(slots=jcp.slots.reshape(rows.shape)),
                  jhp._replace(slots=jhp.slots.reshape(rows.shape)))
    else:
        got = ops.fused_front_end(*map(_tt, args), _tt(scales))
    want = jops.fused_front_end(*map(_jj, args), _jj(scales),
                                dedup_plans=jplans, impl="pallas",
                                interpret=True, block_l=3, block_b=2)
    _equal(got, want, f"fused_front_end {storage} dedup={dedup}")


@pytest.mark.parametrize("S", [1, S4])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_kernel_oob_partial_pool_reads_each_slice_as_pallas(storage, S):
    """``ops.fused_partial_pool`` over S slices of the cold tier reads an
    id against its shard's slice (VC / S rows), as the reference's Pallas
    partial pool does on each shard's local table (called once per
    slice): an id past a slice's end reads that slice's last row, never
    the next slice's; the hot tier's ids against VH.  Bitwise."""
    cold, hot, x, rows, owned, is_hot, w, scales = _fe_inputs(5 + S, storage,
                                                              S)
    R = VC // S
    own = owned[0] if S == 1 else owned
    pc, ph = ops.fused_partial_pool(*map(_tt, (cold, hot, x, rows, own,
                                               is_hot, w, scales)))
    pc = pc[None] if S == 1 else pc
    for s in range(S):
        jc, jh = jops.fused_partial_pool(
            *map(_jj, (cold[s * R:(s + 1) * R], hot, x, rows, owned[s],
                       is_hot, w)), scales=_jj(scales), impl="pallas",
            interpret=True, block_l=3, block_b=2)
        _equal(pc[s], jc, f"part_c[{s}] {storage} S={S}")
        _equal(ph, jh, f"part_h {storage} S={S}")


@pytest.mark.parametrize("S", [1, S4])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_kernel_oob_partial_pool_dedup_reads_the_plans_rows(storage, S):
    """``ops.fused_partial_pool_dedup``: at one shard, through the port's
    plans, equal to the reference's Pallas partial pool through its own
    plans bitwise.  At S shards (where the plan's sentinel is no owned
    id: see ROADMAP, queue 3) the cold plan holds rows of the whole
    cold tier (the caller's slice offsets added to the normalised ids),
    with ids past the whole tier's ends in place of its first and last
    rows (-VC - 1, -2**31; VC + 93, -1), read against the whole tier;
    the hot plan holds the raw ids.  Equal bitwise to the per-entry pool
    on the raw ids, which reads each against its own slice."""
    cold, hot, x, rows, owned, is_hot, w, scales = _fe_inputs(7 + S, storage,
                                                              S)
    R = VC // S
    nb = KB * KG
    flat = rows.reshape(nb, KL)
    if S == 1:
        cold_ids = flat
    else:
        g = (_rows_read(flat, R)[None]
             + R * np.arange(S).reshape(S, 1, 1)).reshape(S * nb, KL)
        alt = np.arange(g.size).reshape(g.shape) % 2 == 0
        g = np.where(g == VC - 1, np.where(alt, VC + 93, -1), g)
        g = np.where(g == 0, np.where(alt, -VC - 1, -2 ** 31), g)
        cold_ids = g.astype(np.int32)
    rep = 1 if S == 1 else S
    s_rep = None if scales is None else np.tile(scales.reshape(nb, KL),
                                                (rep, 1))
    cp = core_sls.dedup_plan(_tt(cold_ids), _tt(owned.reshape(rep * nb, KL)),
                             _tt(s_rep))
    hp = core_sls.dedup_plan(_tt(flat), _tt(is_hot.reshape(nb, KL)))
    own = owned[0] if S == 1 else owned
    cp = cp._replace(slots=cp.slots.reshape(own.shape))
    hp = hp._replace(slots=hp.slots.reshape(rows.shape))
    dc, dh = ops.fused_partial_pool_dedup(*map(_tt, (cold, hot, x)), cp, hp,
                                          _tt(own), _tt(is_hot), _tt(w))
    if S == 1:
        jcp = jsls.dedup_plan(_jj(flat), _jj(own.reshape(nb, KL)),
                              _jj(s_rep))
        jhp = jsls.dedup_plan(_jj(flat), _jj(is_hot.reshape(nb, KL)))
        jc, jh = jops.fused_partial_pool(
            *map(_jj, (cold, hot, x, rows, own, is_hot, w)),
            dedup_plans=(jcp._replace(slots=jcp.slots.reshape(rows.shape)),
                         jhp._replace(slots=jhp.slots.reshape(rows.shape))),
            impl="pallas", interpret=True, block_l=3, block_b=2)
        _equal(dc, jc, f"part_c {storage} S=1")
        _equal(dh, jh, f"part_h {storage} S=1")
        return
    pc, ph = ops.fused_partial_pool(*map(_tt, (cold, hot, x, rows, own,
                                               is_hot, w, scales)))
    _equal(dc, pc, f"gather-once part_c {storage} S={S}")
    _equal(dh, ph, f"gather-once part_h {storage} S={S}")


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("entry", ["masked_partial_sls", "fused_partial_pool"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_kernel_oob_dense_partial_pools_read_each_slice(storage, entry,
                                                       dedup):
    """The dense S-slice pools of ``core/sls.py`` on raw out-of-range and
    negative ids, per-entry and through their gather-once plans, equal
    the pool of each slice on its own table bitwise: an id past a slice's
    edge reads that slice's row, never a neighbour's."""
    cold, hot, x, rows, owned, is_hot, w, scales = _fe_inputs(11, storage,
                                                              S4)
    R = VC // S4
    if entry == "fused_partial_pool":
        got, gh = core_sls.fused_partial_pool_dense(
            *map(_tt, (cold, hot, x, rows, owned, is_hot, w, scales)),
            impl="torch", dedup=dedup)
        for s in range(S4):
            wc, wh = ops.fused_partial_pool(
                *map(_tt, (cold[s * R:(s + 1) * R], hot, x, rows, owned[s],
                           is_hot, w, scales)))
            _equal(got[s], wc, f"part_c[{s}] {storage} dedup={dedup}")
            _equal(gh, wh, f"part_h {storage} dedup={dedup}")
        return
    nb = KB * KG
    flat, s2 = rows.reshape(nb, KL), _tt(None if scales is None
                                         else scales.reshape(nb, KL))
    got = core_sls.masked_partial_sls_dense(
        _tt(cold), _tt(flat), _tt(owned.reshape(S4, nb, KL)),
        _tt(w.reshape(nb, KL)), impl="torch", scales=s2, dedup=dedup)
    for s in range(S4):
        want = ops.masked_sls(_tt(cold[s * R:(s + 1) * R]), _tt(flat),
                              _tt(owned[s].reshape(nb, KL)),
                              _tt(w.reshape(nb, KL)), s2)
        _equal(got[s], want, f"shard {s} {storage} dedup={dedup}")


@pytest.mark.parametrize("entry", ["masked_sls", "masked_sls_dedup"])
def test_kernel_oob_backward_lands_on_the_rows_read(entry):
    """The table's gradient of ``masked_sls`` (and ``masked_sls_dedup``)
    on raw out-of-range and negative ids equals its gradient on the
    normalised ids: each entry's gradient lands on the row its forward
    read.  Masked entries give none."""
    table, idx, owned, w, _ = _sls_inputs(9, "fp32")
    norm = _rows_read(idx, VH).astype(np.int32)

    def grad(ids):
        t = _tt(table).requires_grad_(True)
        if entry == "masked_sls":
            out = ops.masked_sls(t, _tt(ids), _tt(owned), _tt(w))
        else:
            plan = core_sls.dedup_plan(_tt(ids), _tt(owned))
            out = ops.masked_sls_dedup(t, plan, _tt(owned), _tt(w))
        g_out = torch.as_tensor(np.random.default_rng(0).integers(
            -4, 5, out.shape).astype(np.float32))
        out.backward(g_out)
        return out.detach().numpy(), t.grad.numpy()

    out_raw, g_raw = grad(idx)
    out_norm, g_norm = grad(norm)
    np.testing.assert_array_equal(out_raw, out_norm)
    np.testing.assert_array_equal(g_raw, g_norm)
    assert np.abs(g_raw[VH - 1]).sum() > 0 and np.abs(g_raw[0]).sum() > 0
