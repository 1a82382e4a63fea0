"""``ServeBinding.execute`` copies each batch entry to the device when the
step first reads it (``core/staging.py``): the same scores, bitwise, as
the step on a dict of eagerly copied tensors, across reused buffers and a
second shape; the counters (``staging_stats``), in which a DLRM's lookup
inputs are read late; one tensor per entry; host arrays untouched; tensors
passed through; and the mapping's reads.  A large batch runs as
sub-batches (``core.staging.sub_batches``): the scores are the step's on
the same slices, bitwise, with exact counters and no new signature once
warm.  The last cases run on the card alone, where a batch under
``PINNED_MIN_BYTES`` is copied before the step and DLRM-DCNv2's batch of
16,384 items splits."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import staging
from repro_torch.core.pifs import ServeBinding
from repro_torch.core.staging import PINNED_MIN_BYTES
from repro_torch.models import dlrm
from repro_torch.models.params import initialize
from repro_torch.serving import loadgen
from repro_torch.serving.batcher import Bucket
from repro_torch.serving.request import ArrivalConfig

MODELS = {"fused": ("rmc1", "fused"), "split": ("rmc1", "split"),
          "dcn-v2": ("dcn-v2", "split")}


def _bind(model, device="cpu", full=False):
    arch, front_end = MODELS[model]
    cfg = get_config(arch) if full else reduced(get_config(arch))
    return cfg, loadgen.bind_model(cfg, device, front_end=front_end)


def _batches(cfg, sizes, seed=3):
    """Padded host batches of ``sizes`` items, as the serving padder
    builds them."""
    reqs = loadgen.request_stream(cfg, loadgen.LoadConfig(
        n_requests=sum(sizes), arrival=ArrivalConfig(rate_qps=100.0,
                                                     seed=seed), seed=seed))
    pad = loadgen.make_padder(cfg)
    pooling = getattr(cfg, "pooling", 1)
    out, i = [], 0
    for b in sizes:
        out.append(pad(reqs[i:i + b], Bucket(b, pooling)))
        i += b
    return out


def _eager(binding, batch, device="cpu"):
    """The active step on a plain dict of tensors copied up front."""
    return binding.steps[binding.active](
        binding.state, {k: torch.as_tensor(v, device=device)
                        for k, v in batch.items()})


def _with_step(binding, step):
    return ServeBinding(binding.engine, binding.state, binding.model, step)


@pytest.mark.parametrize("model", list(MODELS))
def test_execute_scores_equal_the_eager_step_bitwise(model):
    cfg, b = _bind(model)
    batches = _batches(cfg, (8, 8, 16))      # one shape twice, then another
    before = [{k: v.copy() for k, v in batch.items()} for batch in batches]
    for batch in batches:
        got = b.execute(batch)
        assert torch.equal(got, _eager(b, batch)), model
    for batch, was in zip(batches, before):
        assert batch.keys() == was.keys()
        for k in batch:
            np.testing.assert_array_equal(batch[k], was[k], err_msg=k)
    assert b.staging_stats()["calls"] == 3


def _reads_everything_first(step):
    def first(state, batch):
        return step(state, dict(batch.items()))
    return first


@pytest.mark.parametrize("order", ["dlrm", "reads_everything_first"])
def test_late_bytes_count_the_entries_read_after_the_first(order):
    cfg, b = _bind("fused")
    if order != "dlrm":
        b = _with_step(b, _reads_everything_first(b.steps["full"]))
    batch, = _batches(cfg, (16,))
    b.execute(batch)
    want_late = (batch["indices"].nbytes + batch["weights"].nbytes
                 if order == "dlrm" else 0)
    assert b.staging_stats() == {
        "calls": 1, "bytes": sum(v.nbytes for v in batch.values()),
        "late_bytes": want_late, "split_calls": 0, "sub_batches": 0}
    assert torch.equal(b.execute(batch), _eager(b, batch))
    b.reset_plan_stats()
    assert b.staging_stats() == {"calls": 0, "bytes": 0, "late_bytes": 0,
                                 "split_calls": 0, "sub_batches": 0}
    assert "late_bytes" not in b.plan_stats()


def test_a_second_read_returns_the_same_tensor():
    cfg, b = _bind("fused")
    step = b.steps["full"]
    seen = {}

    def twice(state, batch):
        seen["dense"] = batch["dense"], batch["dense"]
        out = step(state, batch)
        seen["indices"] = batch["indices"], batch.get("indices")
        return out
    batch, = _batches(cfg, (8,))
    want = _eager(b, batch)
    b = _with_step(b, twice)
    assert torch.equal(b.execute(batch), want)
    for k, (first, second) in seen.items():
        assert first is second, k
    assert b.staging_stats()["bytes"] == sum(v.nbytes
                                             for v in batch.values())


def test_tensors_pass_through_and_count_no_bytes():
    cfg, b = _bind("split")
    batch, = _batches(cfg, (8,))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    step = b.steps["full"]
    seen = {}

    def keep(state, staged):
        seen.update((k, staged[k]) for k in staged)
        return step(state, staged)
    want = _eager(b, batch)
    b = _with_step(b, keep)
    assert torch.equal(b.execute(tb), want)
    assert all(seen[k] is tb[k] for k in tb)
    assert b.staging_stats() == {"calls": 1, "bytes": 0, "late_bytes": 0,
                                 "split_calls": 0, "sub_batches": 0}


def test_the_staged_batch_is_a_read_only_mapping():
    cfg, b = _bind("fused")
    batch, = _batches(cfg, (8,))
    staged = b._stager.batch(batch)
    assert len(staged) == len(batch) and list(staged) == list(batch)
    assert "dense" in staged and "labels" not in staged
    assert staged.get("labels") is None
    with pytest.raises(KeyError):
        staged["labels"]
    assert staged.keys() == batch.keys()
    assert b.staging_stats()["bytes"] == 0          # nothing read yet
    dense = staged["dense"]
    items = dict(staged.items())                    # the rest, one read
    assert items["dense"] is dense and set(items) == set(batch)
    assert [v is items[k] for k, v in zip(staged, staged.values())] \
        == [True] * len(batch)
    assert b.staging_stats()["late_bytes"] == sum(
        v.nbytes for k, v in batch.items() if k != "dense")
    with pytest.raises(TypeError):
        staged["dense"] = dense


def _split_at(monkeypatch, k):
    """Size constants under which a batch of a few items splits into
    ``k`` sub-batches."""
    monkeypatch.setattr(staging, "SPLIT_MIN_BYTES", 1)
    monkeypatch.setattr(staging, "SPLIT_MIN_ITEMS", 1)
    monkeypatch.setattr(staging, "SPLIT_MAX", k)


def _slices(batch, k):
    """``batch`` cut along axis 0 as ``execute`` cuts it."""
    n = len(next(iter(batch.values())))
    edges = [n * j // k for j in range(k + 1)]
    return [{key: x[a:b] for key, x in batch.items()}
            for a, b in zip(edges[:-1], edges[1:])]


def _counting(binding):
    """``binding`` with its step wrapped to count its calls."""
    step = binding.steps["full"]
    calls = []

    def counted(state, batch):
        calls.append(len(batch["dense"]))
        return step(state, batch)
    return _with_step(binding, counted), calls


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("model", list(MODELS))
def test_a_split_batch_scores_as_the_step_on_its_slices(model, k,
                                                        monkeypatch):
    _split_at(monkeypatch, k)
    cfg, b = _bind(model)
    batches = _batches(cfg, (12, 11))        # k divides 12, not 11
    before = [{key: v.copy() for key, v in batch.items()}
              for batch in batches]
    counted, calls = _counting(b)
    for batch in batches:
        got = counted.execute(batch)
        parts = [_eager(b, part) for part in _slices(batch, k)]
        assert torch.equal(got, torch.cat(parts)), model
        torch.testing.assert_close(got, _eager(b, batch), rtol=0,
                                   atol=1e-6)
    assert calls == [len(p["dense"]) for batch in batches
                     for p in _slices(batch, k)]
    assert len(calls) == 2 * k and len(set(calls[k:])) == 2   # 11 items
    for batch, was in zip(batches, before):
        assert batch.keys() == was.keys()
        for key in batch:
            np.testing.assert_array_equal(batch[key], was[key], err_msg=key)
    s = counted.staging_stats()
    assert s["calls"] == 2 and s["split_calls"] == 2
    assert s["sub_batches"] == 2 * k
    assert s["bytes"] == sum(v.nbytes for batch in batches
                             for v in batch.values())
    if model != "dcn-v2":                    # a DLRM reads its lookup late
        assert s["late_bytes"] == sum(v.nbytes for batch in batches
                                      for key, v in batch.items()
                                      if key != "dense")


@pytest.mark.parametrize("model", list(MODELS))
def test_a_split_batch_makes_no_new_signature_when_warm(model, monkeypatch):
    _split_at(monkeypatch, 3)
    cfg, b = _bind(model)
    batch, other = _batches(cfg, (11, 11), seed=5)
    b.execute(batch)                                  # warm-up
    b.reset_plan_stats()
    got = b.execute(other)
    assert b.plan_stats()["traces"] == 0
    assert torch.equal(got, torch.cat([_eager(b, p)
                                       for p in _slices(other, 3)]))
    s = b.staging_stats()
    assert (s["calls"], s["split_calls"], s["sub_batches"]) == (1, 1, 3)


@pytest.mark.parametrize("limit", ["bytes", "items", "max"])
@pytest.mark.parametrize("model", list(MODELS))
def test_a_batch_under_the_split_limits_runs_as_one_step(model, limit,
                                                         monkeypatch):
    cfg, b = _bind(model)
    batch, = _batches(cfg, (12,))
    nbytes = sum(v.nbytes for v in batch.values())
    _split_at(monkeypatch, 4)
    if limit == "bytes":          # two sub-batches would fall under it
        monkeypatch.setattr(staging, "SPLIT_MIN_BYTES", nbytes // 2 + 1)
    elif limit == "items":
        monkeypatch.setattr(staging, "SPLIT_MIN_ITEMS", 7)
    else:
        monkeypatch.setattr(staging, "SPLIT_MAX", 1)
    assert staging.sub_batches(batch) == 1
    counted, calls = _counting(b)
    assert torch.equal(counted.execute(batch), _eager(b, batch))
    assert calls == [12]
    s = counted.staging_stats()
    assert (s["calls"], s["split_calls"], s["sub_batches"]) == (1, 0, 0)


def test_a_step_that_raises_mid_batch_leaves_the_binding_serving(
        monkeypatch):
    _split_at(monkeypatch, 3)
    cfg, b = _bind("fused")
    batch, = _batches(cfg, (12,))
    step = b.steps["full"]
    seen = []

    def fails_second(state, staged):
        seen.append(len(staged["dense"]))
        if len(seen) == 2:
            raise RuntimeError("sub-batch 1")
        return step(state, staged)
    bad = _with_step(b, fails_second)
    with pytest.raises(RuntimeError, match="sub-batch 1"):
        bad.execute(batch)
    assert seen == [4, 4]
    assert bad.staging_stats()["split_calls"] == 1
    assert torch.equal(b.execute(batch), torch.cat(
        [_eager(b, part) for part in _slices(batch, 3)]))


def test_the_split_rule_follows_bytes_and_items():
    """At the library's constants: DLRM-DCNv2's batch of 16,384 items
    splits, an RMC's (9.2 MB) and a serving bucket do not; entries that
    differ in length along axis 0, or tensors, are never cut."""
    def batch(B, ids):
        return {"dense": np.zeros((B, 13), np.float32),
                "indices": np.zeros((B, ids), np.int32),
                "weights": np.zeros((B, ids), np.float32)}
    dcnv2 = batch(16384, 214)
    k = staging.sub_batches(dcnv2)
    assert 1 < k <= staging.SPLIT_MAX
    assert 16384 // k >= staging.SPLIT_MIN_ITEMS
    assert sum(v.nbytes for v in dcnv2.values()) // k \
        >= staging.SPLIT_MIN_BYTES
    assert staging.sub_batches(batch(16384, 64)) == 1        # RMC1-4
    assert staging.sub_batches(batch(512, 214)) == 1         # a bucket
    assert staging.sub_batches(
        {**dcnv2, "lengths": np.zeros(26, np.int32)}) == 1
    assert staging.sub_batches(
        {key: torch.as_tensor(v) for key, v in dcnv2.items()}) == 1


def _card_batch(cfg, engine, B, rng):
    return {"dense": rng.standard_normal((B, cfg.n_dense)).astype(np.float32),
            "indices": rng.integers(0, engine.cfg.total_rows,
                                    (B, cfg.n_tables, cfg.pooling)
                                    ).astype(np.int32),
            "weights": rng.random((B, cfg.n_tables, cfg.pooling)
                                  ).astype(np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["fused", "split"])
def test_card_staging_is_bitwise_at_16384_items(model):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    cfg, b = _bind(model, "cuda", full=True)
    rng = np.random.default_rng(11)
    B = 16384
    batch = _card_batch(cfg, b.engine, B, rng)
    first = b.execute(batch).clone()
    want_first = _eager(b, batch, "cuda")
    # the host arrays change after execute returned: the next call reads
    # the new values, and the scores already returned keep the old ones
    fresh = _card_batch(cfg, b.engine, B, rng)
    for k in batch:
        batch[k][...] = fresh[k]
    second = b.execute(batch)
    assert torch.equal(first, want_first)
    assert torch.equal(second, _eager(b, batch, "cuda"))
    assert not torch.equal(first, second)
    # another shape, under PINNED_MIN_BYTES: copied whole before the step
    other = _card_batch(cfg, b.engine, 96, rng)
    assert torch.equal(b.execute(other), _eager(b, other, "cuda"))
    s = b.staging_stats()
    per = sum(v.nbytes for v in batch.values())
    late = batch["indices"].nbytes + batch["weights"].nbytes
    assert per >= PINNED_MIN_BYTES > sum(v.nbytes for v in other.values())
    assert s["calls"] == 3
    assert s["bytes"] == 2 * per + sum(v.nbytes for v in other.values())
    assert s["late_bytes"] == 2 * late
    assert len(b._stager._buffers) == 3             # three keys, one shape


def _dcnv2_card_batch(cfg, offsets, B, rng):
    """A batch of DLRM-DCNv2's shape: 13 dense features and 214 ids an
    item in its 26 bags, each id drawn from its own table."""
    rows = np.repeat(np.asarray(cfg.table_rows), cfg.bag_lengths)
    base = np.repeat(np.asarray(offsets), cfg.bag_lengths)
    ids = base + (rng.random((B, rows.size)) * rows).astype(np.int64)
    return {"dense": rng.standard_normal((B, cfg.n_dense)).astype(np.float32),
            "indices": ids.astype(np.int32),
            "weights": rng.random(ids.shape).astype(np.float32)}


@pytest.mark.cuda
def test_card_splits_dlrm_dcnv2_at_16384_items_bitwise_per_slice():
    """DLRM-DCNv2 at its widths and bags, tables cut to 100,000 rows:
    its batch of 16,384 items runs as k > 1 sub-batches whose scores equal
    the step's on the same slices bitwise and the whole batch's within the
    cell's limit; host arrays changed after ``execute`` returned reach the
    next call and not the scores already returned."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    full = get_config("dlrm-dcnv2")
    cfg = dataclasses.replace(
        full, vocab_sizes=tuple(min(v, 100_000) for v in full.vocab_sizes),
        emb_num=100_000)
    engine, offsets = dlrm.build_engine(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    model = initialize(dlrm.DLRM(cfg, dev), gen)
    state = engine.init_state(gen)
    b = ServeBinding(engine, state, model, dlrm.make_serve_step(model,
                                                                engine))
    rng = np.random.default_rng(17)
    B = 16384
    batch = _dcnv2_card_batch(cfg, offsets, B, rng)
    k = staging.sub_batches(batch)
    assert k > 1
    b.execute(batch)                                  # warm-up
    b.reset_plan_stats()
    first = b.execute(batch).clone()
    assert b.plan_stats()["traces"] == 0

    def per_slice(batch):
        return torch.cat([_eager(b, part, "cuda")
                          for part in _slices(batch, k)])
    want_first = per_slice(batch)
    whole = _eager(b, batch, "cuda")
    fresh = _dcnv2_card_batch(cfg, offsets, B, rng)
    for key in batch:
        batch[key][...] = fresh[key]
    second = b.execute(batch)
    assert torch.equal(first, want_first)
    assert (first - whole).abs().max().item() <= 1.5e-6
    assert torch.equal(second, per_slice(batch))
    assert not torch.equal(first, second)
    s = b.staging_stats()
    assert (s["calls"], s["split_calls"], s["sub_batches"]) == (2, 2, 2 * k)
    assert s["late_bytes"] == 2 * (batch["indices"].nbytes
                                   + batch["weights"].nbytes)
    assert len(b._stager._buffers) == 3 * k       # three keys a slot
    assert len(b._stager._lanes) == staging.SPLIT_LANES
