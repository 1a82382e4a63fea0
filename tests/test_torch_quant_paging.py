"""Port parity of the numpy / config layers, quantization and paging:
``repro_torch`` against the JAX package on the same seeded inputs.
Everything here must be bitwise (or exactly) equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import paging as jpaging
from repro.core import quant as jquant
from repro.data import traces as jtraces
from repro.serving import batcher as jbatcher
from repro.serving.loadgen import LoadConfig, request_stream as jrequest_stream
from repro.serving.request import ArrivalConfig
from repro.serving.request import Request as JRequest

from repro_torch.configs import get_config, reduced
from repro_torch.core import paging, quant
from repro_torch.data import traces
from repro_torch.serving import batcher, loadgen
from repro_torch.serving.request import ArrivalConfig as PArrivalConfig
from repro_torch.serving.request import Request


@pytest.mark.parametrize("name", ["rmc1", "rmc2", "rmc3", "rmc4"])
def test_configs_match_reference(name):
    """The port's registry holds the same RMC configs, and the same CPU
    shrink."""
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jget_config(name))
    assert dataclasses.asdict(reduced(get_config(name))) == \
        dataclasses.asdict(jreduced(jget_config(name)))


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("total_rows,dim,hot_fraction", [
    (1024, 16, 0.05), (131072, 64, 0.05), (8 * 1048576, 128, 0.05),
    (777, 24, 0.1), (500, 16, 0.0)])
def test_paging_geometry_matches_reference(storage, total_rows, dim,
                                           hot_fraction):
    """Page size comes from *stored* bytes (int8 pages hold 4x the rows);
    every derived size equals the reference's."""
    kw = dict(total_rows=total_rows, dim=dim, n_shards=1,
              hot_fraction=hot_fraction, storage=storage)
    a, b = paging.PagingConfig(**kw), jpaging.PagingConfig(**kw)
    for prop in ("cold_itemsize", "page_size", "num_pages", "hot_pages",
                 "pages_per_shard", "rows_per_shard", "padded_rows",
                 "cold_rows_total", "hot_rows"):
        assert getattr(a, prop) == getattr(b, prop), prop


def test_initial_page_table_and_locate_match_reference():
    cfg = dict(total_rows=3000, dim=16, n_shards=1)
    a, b = paging.PagingConfig(**cfg), jpaging.PagingConfig(**cfg)
    ta, tb = paging.initial_page_table(a), jpaging.initial_page_table(b)
    np.testing.assert_array_equal(ta.page_to_shard.numpy(),
                                  np.asarray(tb.page_to_shard))
    np.testing.assert_array_equal(ta.page_to_slot.numpy(),
                                  np.asarray(tb.page_to_slot))
    # a placement with hot pages: locate agrees row by row
    rng = np.random.default_rng(0)
    shard = np.zeros(a.num_pages, np.int32)
    slot = np.arange(a.num_pages, dtype=np.int32)
    hot = rng.choice(a.num_pages, 5, replace=False)
    shard[hot], slot[hot] = paging.HOT_SHARD, np.arange(5)
    rows = rng.integers(0, a.padded_rows, 400).astype(np.int32)
    got = paging.locate(a, paging.PageTable(torch.as_tensor(shard),
                                            torch.as_tensor(slot)),
                        torch.as_tensor(rows))
    want = jpaging.locate(b, jpaging.PageTable(jnp.asarray(shard),
                                               jnp.asarray(slot)),
                          jnp.asarray(rows))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("D,page_size", [(16, 64), (64, 16), (128, 32)])
def test_quantize_pages_bitwise(D, page_size):
    """Codes and scales equal the reference bit for bit: amax/127 scales,
    1.0 for an all-zero page, round half to even, clip to +-127."""
    rng = np.random.default_rng(D)
    pages = (rng.normal(size=(6, page_size, D))
             * rng.uniform(1e-3, 10, (6, 1, 1))).astype(np.float32)
    pages[2] = 0.0                                  # all-zero page
    # exact .5 multiples of the scale exercise round-half-to-even
    pages[3, 0, :4] = np.float32(127.0)
    pages[3, 1, :4] = np.float32([0.5, 1.5, 2.5, -2.5])
    q, s = quant.quantize_pages(torch.as_tensor(pages))
    jq, js = jquant.quantize_pages(jnp.asarray(pages))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s[2].item() == 1.0 and q.dtype == torch.int8
    np.testing.assert_array_equal(
        quant.dequantize_pages(q, s).numpy(),
        np.asarray(jquant.dequantize_pages(jq, js)))
    # re-quantizing with the carried scale recovers the codes
    np.testing.assert_array_equal(
        quant.quantize_rows(quant.dequantize_pages(q, s),
                            s[:, None, None]).numpy(), q.numpy())


@pytest.mark.parametrize("distribution",
                         ["zipfian", "normal", "uniform", "random"])
def test_trace_generator_same_seed_same_ids(distribution):
    """Batch stream (with drift) and serve-request stream equal the
    reference's for the same seed."""
    kw = dict(n_rows=5000, n_tables=3, pooling=4, batch=6,
              distribution=distribution, seed=7, drift_window=512)
    a = traces.TraceGenerator(traces.TraceConfig(**kw))
    b = jtraces.TraceGenerator(jtraces.TraceConfig(**kw))
    for _ in range(3):
        np.testing.assert_array_equal(a.next_batch(), b.next_batch())
    for x, y in zip(a.serve_requests(9, poolings=(2, 4), drift_every=4),
                    b.serve_requests(9, poolings=(2, 4), drift_every=4)):
        np.testing.assert_array_equal(x, y)


def _requests(cls, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    out = []
    for i, lr in enumerate((3, 1, 4, 2)):
        feats = {"indices": rng.integers(0, 100, (3, lr)).astype(np.int32),
                 "dense": rng.normal(size=(5,)).astype(np.float32)}
        out.append(cls(rid=i, arrival_s=0.1 * i, deadline_s=1.0,
                       features=feats, pooling=lr))
    return out


def test_batcher_padding_and_decisions_match_reference():
    """Exact padding (weight-0 pooling pad, replicated batch pad) and the
    fixed batcher's flush/wait decisions equal the reference's."""
    reqs, jreqs = _requests(Request), _requests(JRequest)
    bucket, jbucket = batcher.Bucket(6, 4), jbatcher.Bucket(6, 4)
    idx, w = batcher.pad_pooled_indices(reqs, bucket)
    jidx, jw = jbatcher.pad_pooled_indices(jreqs, jbucket)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(w, jw)
    assert set(np.unique(w)) <= {0.0, 1.0}
    np.testing.assert_array_equal(
        batcher.stack_feature(reqs, bucket, "dense"),
        jbatcher.stack_feature(jreqs, jbucket, "dense"))
    fb, jfb = batcher.FixedBatcher(2, 4), jbatcher.FixedBatcher(2, 4)
    svc, jsvc = batcher.FixedServiceModel(), jbatcher.FixedServiceModel()
    for n, nxt in ((0, 1.0), (1, 1.0), (1, None), (3, 2.0)):
        a = fb.decide(0.0, reqs[:n], nxt, svc)
        b = jfb.decide(0.0, jreqs[:n], nxt, jsvc)
        assert type(a).__name__ == type(b).__name__
        if b is not None:
            assert dataclasses.astuple(a) == dataclasses.astuple(b)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_request_stream_matches_reference_loadgen(storage):
    """The port's serve stream carries the reference loadgen's ids (with
    its int8 page-rounded table offsets) and dense features."""
    cfg = jreduced(jget_config("rmc1"))
    load = LoadConfig(n_requests=12, arrival=ArrivalConfig(rate_qps=100.0),
                      seed=3, storage=storage, drift_every=5)
    want = jrequest_stream(cfg, load)
    got = loadgen.request_stream(reduced(get_config("rmc1")),
                                 loadgen.LoadConfig(
                                     12, PArrivalConfig(rate_qps=100.0),
                                     seed=3, storage=storage, drift_every=5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.features["indices"],
                                      w.features["indices"])
        np.testing.assert_array_equal(g.features["dense"],
                                      w.features["dense"])
