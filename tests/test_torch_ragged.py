"""Bags that differ in length (MLPerf DLRM-DCNv2's multi-hot tables): the
``ragged_sls`` kernel's plain version against sums by hand, the engine's
ragged lookup against its uniform datapath bit for bit, the int8 build
from codes (``from_codes``) and the in-place move (``migrate`` where
the card's free memory is short) against their functional twins, the
signature count, the
low-rank cross layer and the ``dcn`` DLRM.  The last cases run the kernel
on the card against its plain version (D 128, the published bag lengths,
a cold-tier row past element 2**31) and skip here.

This file imports nothing of JAX, so that its card cases run on a machine
without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_ragged.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.dlrm_dcnv2 import MULTI_HOT, VOCAB_SIZES
from repro_torch.core import pifs
from repro_torch.core.paging import HOT_SHARD, PageTable
from repro_torch.core.pifs import engine_for_tables
from repro_torch.core.planner import plan
from repro_torch.kernels import build, ops, ref
from repro_torch.models import dlrm
from repro_torch.models.layers import LowRankCross
from repro_torch.models.params import initialize

D = 16


def _edges(lengths):
    return tuple(int(c) for c in np.concatenate([[0], np.cumsum(lengths)]))


def _table(storage, V, gen):
    if storage == "int8":
        return torch.randint(-127, 128, (V, D), generator=gen,
                             dtype=torch.int8)
    return torch.randn((V, D), generator=gen)


def _entries(lengths, N, V, storage, gen, masked=True):
    C = sum(lengths)
    idx = torch.randint(0, V, (N, C), generator=gen, dtype=torch.int32)
    owned = (torch.rand((N, C), generator=gen) < 0.7) if masked else None
    w = torch.rand((N, C), generator=gen)
    scales = (torch.rand((N, C), generator=gen) + 0.5
              if storage == "int8" else None)
    return idx, owned, w, scales


# ------------------------------------------------------- the plain version
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_plain_ragged_pooling_against_sums_by_hand(storage):
    """Single-id bags, a 100-id bag, an empty bag and some between: each
    bag the masked, weighted, dequantized sum of its own columns, added in
    column order, exactly."""
    gen = torch.Generator().manual_seed(3)
    lengths = (1, 100, 0, 3, 1, 7)
    V, N = 50, 5
    table = _table(storage, V, gen)
    idx, owned, w, scales = _entries(lengths, N, V, storage, gen)
    edges = _edges(lengths)
    got = ops.ragged_sls(table, idx, edges, owned, w, scales)
    assert got.shape == (N, len(lengths), D) and got.dtype == torch.float32
    for n in range(N):
        for t in range(len(lengths)):
            acc = torch.zeros(D)
            for c in range(edges[t], edges[t + 1]):
                row = table[idx[n, c]].float()
                if scales is not None:
                    row = row * scales[n, c]
                acc = acc + (float(owned[n, c]) * w[n, c]) * row
            assert torch.equal(got[n, t], acc), (n, t)
    assert not got[:, 2].any()                      # the empty bag


def test_plain_ragged_pooling_with_no_mask_and_no_weights_is_plain_sls():
    gen = torch.Generator().manual_seed(4)
    lengths = (2, 1, 5)
    table = _table("fp32", 30, gen)
    idx, _, _, _ = _entries(lengths, 4, 30, "fp32", gen)
    got = ops.ragged_sls(table, idx, _edges(lengths))
    e = _edges(lengths)
    for t in range(3):
        want = ref.sls_ref(table, idx[:, e[t]:e[t + 1]])
        assert torch.equal(got[:, t], want)


@pytest.mark.parametrize("edges", [(1, 3), (0, 2, 1, 3), (0, 2), (0, 4)],
                         ids=["not-from-0", "falling", "short", "past"])
def test_ragged_pooling_refuses_edges_that_do_not_cut_the_columns(edges):
    gen = torch.Generator().manual_seed(5)
    table = _table("fp32", 10, gen)
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.ragged_sls(table, idx, edges)


def test_ragged_pooling_takes_no_gradient():
    table = torch.randn((10, D), requires_grad=True)
    with pytest.raises(RuntimeError):
        ops.ragged_sls(table, torch.zeros((2, 3), dtype=torch.int32),
                       (0, 1, 3))


# --------------------------------------------------------------- the engine
def _engine(storage, S=1, rows=(300, 40, 1000, 8), hot_fraction=0.1):
    eng, offs = engine_for_tables(list(rows), D, device="cpu",
                                  storage=storage, n_shards=S,
                                  hot_fraction=hot_fraction)
    gen = torch.Generator().manual_seed(7)
    state = eng.init_state(gen)
    return eng, offs, state


def _ids(offs, rows, lengths, B, gen):
    cols = [torch.randint(0, r, (B, n), generator=gen) + int(o)
            for o, r, n in zip(offs, rows, lengths)]
    return torch.cat(cols, dim=1).to(torch.int32)


def _placed(eng, state, ids):
    state = eng.observe(state, ids)
    return eng.plan_and_migrate(state)[0]


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_ragged_lookup_equals_each_tables_uniform_lookup(storage, S):
    """Each table's bags through the uniform datapath (one table, its own
    L) equal the ragged lookup's bit for bit, both tiers in use."""
    rows, lengths = (300, 40, 1000, 8), (3, 1, 9, 2)
    eng, offs, state = _engine(storage, S, rows)
    gen = torch.Generator().manual_seed(8)
    ids = _ids(offs, rows, lengths, 6, gen)
    state = _placed(eng, state, ids)
    assert (state.page_to_shard == HOT_SHARD).any()
    w = (torch.rand(ids.shape, generator=gen) < 0.8).float()
    edges = _edges(lengths)
    got = eng.lookup(state, ids, w, bag_edges=edges)
    assert got.shape == (6, 4, D)
    for t in range(4):
        a, b = edges[t], edges[t + 1]
        want = eng.lookup(state, ids[:, None, a:b].contiguous(),
                          w[:, None, a:b].contiguous())
        assert torch.equal(got[:, t], want[:, 0]), t
    hot = eng.lookup(state, ids, w, bag_edges=edges, tiers="hot_only")
    for t in range(4):
        a, b = edges[t], edges[t + 1]
        want = eng.lookup(state, ids[:, None, a:b].contiguous(),
                          w[:, None, a:b].contiguous(), tiers="hot_only")
        assert torch.equal(hot[:, t], want[:, 0]), t


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_ragged_lookup_of_equal_bags_is_the_uniform_lookup(storage):
    eng, offs, state = _engine(storage)
    gen = torch.Generator().manual_seed(9)
    rows = (300, 40, 1000, 8)
    ids = _ids(offs, rows, (4,) * 4, 5, gen)
    state = _placed(eng, state, ids)
    got = eng.lookup(state, ids, bag_edges=_edges((4,) * 4))
    assert torch.equal(got, eng.lookup(state, ids.reshape(5, 4, 4)))


def test_ragged_lookup_launches_one_kernel_a_tier_and_counts_signatures():
    class Calls:
        def __init__(self):
            self.n = {}

        def kernel_enter(self, name):
            self.n[name] = self.n.get(name, 0) + 1

        def kernel_exit(self, name):
            pass
    eng, offs, state = _engine("int8")
    gen = torch.Generator().manual_seed(10)
    lengths = (5, 1, 2, 7)
    ids = _ids(offs, (300, 40, 1000, 8), lengths, 4, gen)
    sink = Calls()
    build.SINKS.append(sink)
    try:
        eng.lookup(state, ids, bag_edges=_edges(lengths))
    finally:
        build.SINKS.remove(sink)
    assert sink.n == {"ragged_sls": 2}
    eng.reset_plan_stats()
    eng.lookup(state, ids, bag_edges=_edges(lengths))
    stats = eng.plan_stats()
    assert stats["traces"] == 0 and stats["ragged"] == 1
    eng.lookup(state, ids, bag_edges=_edges((1, 5, 2, 7)))
    stats = eng.plan_stats()
    assert stats["traces"] == 1 and stats["ragged"] == 2


def test_ragged_signatures_are_counted_by_their_tag():
    """A uniform lookup beside a ragged one: two signatures, one ragged,
    whose label names the bag lengths."""
    eng, offs, state = _engine("fp32")
    gen = torch.Generator().manual_seed(15)
    ids = _ids(offs, (300, 40, 1000, 8), (4,) * 4, 3, gen)
    eng.lookup(state, ids.reshape(3, 4, 4))
    eng.lookup(state, ids, bag_edges=_edges((4,) * 4))
    stats = eng.plan_stats()
    assert stats["plans"] == 2 and stats["ragged"] == 1
    labels = [eng._key_label(k) for k in eng._seen]
    assert sum("/bags=4-4-4-4/" in lb for lb in labels) == 1


@pytest.mark.parametrize("mode,dedup", [("pond", "off"), ("pifs", "on")])
def test_ragged_lookup_refuses_pond_and_dedup(mode, dedup):
    eng, offs, state = _engine("fp32")
    ids = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        eng.lookup(state, ids, mode=mode, dedup=dedup,
                   bag_edges=(0, 1, 2, 3, 4))


# --------------------------------------------------- build and move in place
def _codes(eng, gen):
    c = eng.cfg
    codes = torch.randint(-127, 128, (c.padded_rows, c.dim), generator=gen,
                          dtype=torch.int8)
    scales = torch.rand((c.num_pages,), generator=gen) + 0.5
    return codes, scales


def _same_state(a, b):
    for f in ("cold", "hot", "page_scales", "page_to_shard", "page_to_slot",
              "counts"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("S", [1, 2])
def test_from_codes_packs_as_pack_state(S, monkeypatch):
    """Under a placement with hot pages, page range by page range: the
    same tiers as pack_state of (codes, code * scale, scales)."""
    eng, offs, state = _engine("int8", S)
    gen = torch.Generator().manual_seed(11)
    codes, scales = _codes(eng, gen)
    counts = torch.rand(eng.cfg.num_pages, generator=gen).numpy()
    table, _ = plan(eng.cfg, state.page_table, counts, eng.planner)
    values = codes.float() * scales.repeat_interleave(eng.cfg.page_size)[
        :, None]
    want = eng.pack_state(codes, values, scales, table)
    monkeypatch.setattr(pifs, "MOVE_BLOCK_PAGES", 5)
    got = eng.from_codes(codes, scales, table)
    _same_state(got, want)
    with pytest.raises(ValueError):
        eng.from_codes(codes[1:], scales)
    fp32, _, _ = _engine("fp32", S)
    with pytest.raises(TypeError):
        fp32.from_codes(codes, scales)


def _mapped_rows(eng, state):
    """Storage rows that a page maps to: (cold rows, hot rows)."""
    cold_dst, _, hot_dst, _ = eng._page_rows(state.page_table)
    return cold_dst, hot_dst


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_migrate_in_place_equals_the_functional_move(storage, S,
                                                      monkeypatch):
    """Promotions, then demotions and hot moves (another hot set), and
    at two shards cold moves: every mapped row equals the functional
    move's, the exported table and lookups equal, the tiers are the input
    state's own tensors."""
    monkeypatch.setattr(pifs, "MOVE_BLOCK_PAGES", 3)
    eng, offs, state = _engine(storage, S)
    gen = torch.Generator().manual_seed(12)
    P = eng.cfg.num_pages
    for step in range(3):
        counts = torch.rand(P, generator=gen).numpy() ** 4 * 100
        table, _ = plan(eng.cfg, state.page_table, counts, eng.planner)
        new = PageTable(torch.as_tensor(table.page_to_shard),
                        torch.as_tensor(table.page_to_slot))
        want = eng.migrate(state, new)
        copy = type(state)(**{f: getattr(state, f).clone() for f in (
            "cold", "hot", "page_scales", "page_to_shard", "page_to_slot",
            "counts")})
        with monkeypatch.context() as m:
            m.setattr(type(eng), "_move_in_place", lambda self, st: True)
            got = eng.migrate(copy, new)
        assert got.cold is copy.cold and got.hot is copy.hot
        cold_rows, hot_rows = _mapped_rows(eng, want)
        assert torch.equal(got.cold[cold_rows], want.cold[cold_rows])
        assert torch.equal(got.hot[hot_rows], want.hot[hot_rows])
        for a, b in zip(eng.export_state(got), eng.export_state(want)):
            assert torch.equal(a, b)
        assert torch.equal(got.counts, want.counts)
        ids = torch.randint(0, eng.cfg.total_rows, (4, 2, 3),
                            generator=gen, dtype=torch.int32)
        assert torch.equal(eng.lookup(got, ids), eng.lookup(want, ids))
        state = want
    assert (state.page_to_shard == HOT_SHARD).sum() > 0


def test_migrate_off_the_card_moves_functionally():
    """Off a CUDA device the move never runs in place: the input state's
    tiers are left as they were."""
    eng, offs, state = _engine("int8")
    counts = torch.rand(eng.cfg.num_pages,
                        generator=torch.Generator().manual_seed(14)).numpy()
    table, _ = plan(eng.cfg, state.page_table, counts, eng.planner)
    before = state.cold.clone(), state.hot.clone()
    assert not eng._move_in_place(state)
    got = eng.migrate(state, PageTable(torch.as_tensor(table.page_to_shard),
                                       torch.as_tensor(table.page_to_slot)))
    assert got.cold is not state.cold and got.hot is not state.hot
    assert torch.equal(state.cold, before[0])
    assert torch.equal(state.hot, before[1])


# ------------------------------------------------------------------ models
def test_low_rank_cross_by_hand():
    gen = torch.Generator().manual_seed(13)
    cross = LowRankCross(12, 3, 2)
    initialize(cross, gen)
    with torch.no_grad():
        cross.layer1_b.normal_(generator=gen)
    x0 = torch.randn((5, 12), generator=gen)
    x = x0
    for i in range(2):
        v, w, b = (getattr(cross, f"layer{i}_{k}") for k in "vwb")
        x = x0 * ((x @ v) @ w + b) + x
    assert torch.equal(cross(x0), x)
    assert [n for n, _ in cross.named_parameters()] == [
        "layer0_v", "layer0_w", "layer0_b", "layer1_v", "layer1_w",
        "layer1_b"]


def test_the_registered_config_holds_the_published_widths():
    cfg = get_config("dlrm-dcnv2")
    assert cfg.table_rows == VOCAB_SIZES and sum(VOCAB_SIZES) == 204184588
    assert cfg.bag_lengths == MULTI_HOT and sum(MULTI_HOT) == 214
    assert (cfg.emb_dim, cfg.n_dense, cfg.bottom_mlp, cfg.top_mlp,
            cfg.interaction, cfg.cross_layers, cfg.cross_rank) == (
        128, 13, (512, 256, 128), (1024, 1024, 512, 256, 1), "dcn", 3, 512)
    assert cfg.bag_edges[-1] == 214 and len(cfg.bag_edges) == 27
    assert get_config("rmc4").bag_edges is None


def test_dcn_dlrm_by_hand_and_its_spans():
    """The dcn branch: x0 = [bottom(dense), pooled bags] crossed, then the
    top MLP, against the same towers applied by hand to the engine's
    pooling; a fused front end is refused."""
    cfg = reduced(get_config("dlrm-dcnv2"))
    eng, offs = dlrm.build_engine(cfg, "cpu", storage="int8")
    model = dlrm.DLRM(cfg, "cpu")
    gen = torch.Generator().manual_seed(14)
    initialize(model, gen)
    state = eng.init_state(gen)
    ids = _ids(offs, cfg.table_rows, cfg.bag_lengths, 6, gen)
    batch = {"dense": torch.randn((6, 13), generator=gen), "indices": ids,
             "weights": torch.ones(ids.shape)}
    step = dlrm.make_serve_step(model, eng)
    got = step(state, batch)
    with torch.no_grad():
        pooled = eng.lookup(state, ids, batch["weights"],
                            bag_edges=cfg.bag_edges)
        x0 = torch.cat([model.bottom(batch["dense"])[:, None], pooled],
                       dim=1).reshape(6, -1)
        want = torch.sigmoid(model.top(model.cross(x0))[:, 0])
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        dlrm.make_serve_step(model, eng, front_end="fused")(state, batch)


# ------------------------------------------------------------------- card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_ragged_kernel_equals_plain_on_the_card(storage):
    """D 128, the 26 published bag lengths, 0/1 weights, with and without
    a mask: the kernel equals its plain version bit for bit, in one
    launch.  General weights: the kernel's fmaf against the plain
    multiply then add, within the numerics contract's one rounding a step
    of each bag's L steps, of the sum of the terms' magnitudes, which
    bounds every partial sum."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(15)
    N, V, Dm = 3000, 5000, 128
    table = (torch.randint(-127, 128, (V, Dm), generator=gen, device=dev,
                           dtype=torch.int8) if storage == "int8" else
             torch.randn((V, Dm), generator=gen, device=dev))
    edges = _edges(MULTI_HOT)
    C = edges[-1]
    idx = torch.randint(0, V, (N, C), generator=gen, device=dev,
                        dtype=torch.int32)
    owned = torch.rand((N, C), generator=gen, device=dev) < 0.6
    ones = torch.ones((N, C), device=dev)
    sc = (torch.rand((N, C), generator=gen, device=dev) + 0.5
          if storage == "int8" else None)
    for o in (None, owned):
        build.reset_launches()
        got = ops.ragged_sls(table, idx, edges, o, ones, sc)
        torch.cuda.synchronize()
        assert build.KERNELS["ragged_sls"].launches == 1
        assert torch.equal(got, ops.ragged_sls(table, idx, edges, o, ones,
                                               sc, impl="torch"))
    w = torch.rand((N, C), generator=gen, device=dev)
    got = ops.ragged_sls(table, idx, edges, owned, w, sc)
    want = ops.ragged_sls(table, idx, edges, owned, w, sc, impl="torch")
    magnitude = ops.ragged_sls(table.abs(), idx, edges, owned, w, sc,
                               impl="torch")
    steps = torch.tensor(MULTI_HOT, device=dev, dtype=torch.float32)
    assert ((got - want).abs()
            <= steps[None, :, None] * 2.0 ** -23 * magnitude).all()
    for n in (1, 7, 33):                   # batches that end mid-block
        assert torch.equal(ops.ragged_sls(table, idx[:n], edges, owned[:n],
                                          ones[:n], None if sc is None
                                          else sc[:n]),
                           ops.ragged_sls(table, idx[:n], edges, owned[:n],
                                          ones[:n], None if sc is None
                                          else sc[:n], impl="torch"))


@pytest.mark.cuda
def test_ragged_kernel_reads_rows_past_element_2_31_on_the_card():
    """An int8 tier of 2**24 + 8192 rows of 128 codes (2.15 GB): rows
    whose first element lies past 2**31 are read where the plain version
    reads them, in both the 1-id and the 100-id bags."""
    dev = _card()
    V, Dm = (1 << 24) + 8192, 128
    table = torch.zeros((V, Dm), dtype=torch.int8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    tail = torch.randint(-127, 128, (4096, Dm), generator=gen, device=dev,
                         dtype=torch.int8)
    table[-4096:] = tail
    edges = _edges(MULTI_HOT)
    N, C = 64, edges[-1]
    idx = torch.randint(V - 4096, V, (N, C), generator=gen, device=dev,
                        dtype=torch.int32)
    assert int(idx.min()) * Dm >= 1 << 31
    sc = torch.rand((N, C), generator=gen, device=dev) + 0.5
    got = ops.ragged_sls(table, idx, edges, None, None, sc)
    want = ops.ragged_sls(table, idx, edges, None, None, sc, impl="torch")
    assert torch.equal(got, want) and got.abs().sum() > 0
