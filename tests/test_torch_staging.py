"""``ServeBinding.execute`` copies each batch entry to the device when the
step first reads it (``core/staging.py``): the same scores, bitwise, as
the step on a dict of eagerly copied tensors, across reused buffers and a
second shape; the counters (``staging_stats``), in which a DLRM's lookup
inputs are read late; one tensor per entry; host arrays untouched; tensors
passed through; and the mapping's reads.  The last case runs on the card
alone, where a batch under ``PINNED_MIN_BYTES`` is copied before the
step."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.pifs import ServeBinding
from repro_torch.core.staging import PINNED_MIN_BYTES
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
        "late_bytes": want_late}
    assert torch.equal(b.execute(batch), _eager(b, batch))
    b.reset_plan_stats()
    assert b.staging_stats() == {"calls": 0, "bytes": 0, "late_bytes": 0}
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
    assert b.staging_stats() == {"calls": 1, "bytes": 0, "late_bytes": 0}


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
