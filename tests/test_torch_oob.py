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
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pifs import engine_for_tables as jengine_for_tables
from repro.distributed.sharding import make_mesh
from repro.launch import serve as jserve

from repro_torch.core.paging import HOT_SHARD, PageTable
from repro_torch.core.pifs import engine_for_tables
from repro_torch.kernels import ops
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
