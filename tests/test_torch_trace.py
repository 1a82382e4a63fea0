"""The serve path's spans (``repro_torch/trace.py``): nothing while no
profiler records, one range a call while one does, and in every
``ServeBinding.execute`` of a DLRM the nesting the trace's reduction
(``bench/spans.py``) attributes by: ``pifs.execute`` holding ``pifs.h2d``,
``pifs.step`` and ``pifs.sync`` in that order, the step holding
``pifs.bottom_mlp``, ``pifs.front_end`` and ``pifs.top_mlp``."""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs.base import DLRMConfig
from repro_torch.core.pifs import ServeBinding
from repro_torch.models import dlrm
from repro_torch.models.params import initialize

EXECUTE_CHILDREN = ["pifs.h2d", "pifs.step", "pifs.sync"]
STEP_CHILDREN = ["pifs.bottom_mlp", "pifs.front_end", "pifs.top_mlp"]


def _spans(prof):
    """(start, end, name) of the ``pifs.`` ranges on the host, by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("pifs.")
                  and e.device_type() == DeviceType.CPU)


def test_span_is_one_shared_no_op_without_a_profiler():
    a, b = trace.span("pifs.a"), trace.span("pifs.b")
    assert a is b
    assert not isinstance(a, torch.autograd.profiler.record_function)
    with a:
        pass


def test_span_records_one_range_a_call_under_the_profiler():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        for _ in range(3):
            with trace.span("pifs.test"):
                torch.ones(2).sum()
    finally:
        prof.stop()
    assert [n for _, _, n in _spans(prof)] == ["pifs.test"] * 3
    assert trace.span("pifs.test") is trace.span("pifs.other")


def _binding(front_end: str, seed: int = 5):
    cfg = DLRMConfig(name="tiny", emb_num=512, emb_dim=16,
                     bottom_mlp=(32, 16), top_mlp=(32, 16, 1), n_tables=3,
                     pooling=4)
    gen = torch.Generator().manual_seed(seed)
    engine, offsets = dlrm.build_engine(cfg, "cpu")
    model = initialize(dlrm.DLRM(cfg, "cpu"), gen)
    state = engine.from_dense(torch.randn(
        cfg.emb_num * cfg.n_tables, cfg.emb_dim, generator=gen))
    step = dlrm.make_serve_step(model, engine, front_end=front_end)
    rng = np.random.default_rng(seed)
    B = 8
    batch = {"dense": rng.standard_normal((B, 13)).astype(np.float32),
             "indices": (rng.integers(0, cfg.emb_num, (B, 3, 4))
                         + np.asarray(offsets)[None, :, None]
                         ).astype(np.int32),
             "weights": np.ones((B, 3, 4), np.float32)}
    return ServeBinding(engine, state, model, step), batch


def _children(spans, parent):
    s0, e0, _ = parent
    inside = [s for s in spans if s0 <= s[0] and s[1] <= e0 and s != parent]
    return [s for s in inside if not any(
        o[0] <= s[0] and s[1] <= o[1] and o != s for o in inside)]


@pytest.mark.parametrize("front_end", ["fused", "split"])
def test_execute_nests_the_serve_spans_in_order(front_end):
    binding, batch = _binding(front_end)
    want = binding.execute(batch)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        got = [binding.execute(batch) for _ in range(2)]
    finally:
        prof.stop()
    for g in got:
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    spans = _spans(prof)
    executes = [s for s in spans if s[2] == "pifs.execute"]
    assert len(executes) == 2
    assert len(spans) == 2 * (1 + len(EXECUTE_CHILDREN) + len(STEP_CHILDREN))
    for ex in executes:
        kids = _children(spans, ex)
        assert [k[2] for k in kids] == EXECUTE_CHILDREN
        step = kids[1]
        assert [k[2] for k in _children(spans, step)] == STEP_CHILDREN
