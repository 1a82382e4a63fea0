"""The port's recsys models (SASRec, BST, AutoInt, DCN-v2) against
``repro.models.recsys`` on the CPU: configs, the parameter tree, the
lookups, the serve step and retrieval, and the per-parameter init rule.

The reference side runs on ``repro.distributed.sharding.make_mesh`` meshes
((1, 1) for one shard, (2, 4) for four), its weights carried across with
``params_from_numpy`` and its engine state (a hot tier placed by its
planner) with ``export_state`` / ``pack_state``.

Tolerances.
- Lookups: bitwise, fp32 and int8, pifs and pond, at 1 and 4 shards.  Every
  recsys lookup is an L = 1 bag with no weights: one shard (or the hot
  tier) owns the entry and every other partial is an exact zero.
- Serve scores (sigmoid of the logits): 1e-5 relative and absolute.
  Retrieval scores (raw logits or dot products): 1e-5 relative, 1e-4
  absolute.  Attention, layer norms, cross layers and MLPs reduce their
  inner dimensions in another order in XLA than in torch; no other
  difference is allowed.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data.synth import rec_batches
from repro.distributed.sharding import make_mesh
from repro.models import params as jprm
from repro.models import recsys as jrec

from repro_torch.configs import (REC_SHAPES, get_config, list_archs,
                                 reduced, reduced_shape)
from repro_torch.core.paging import HOT_SHARD, PageTable
from repro_torch.models import dlrm, recsys as rec
from repro_torch.models.params import init_rule, initialize

ARCHS = ["sasrec", "bst", "autoint", "dcn-v2"]
CASES = ARCHS + ["sasrec-d50"]   # SASRec's published D = 50 at vocab 100
B, N_CAND = 16, 64


def _cfgs(name):
    if name == "sasrec-d50":
        return (dataclasses.replace(jreduced(jget_config("sasrec")),
                                    embed_dim=50),
                dataclasses.replace(reduced(get_config("sasrec")),
                                    embed_dim=50))
    return jreduced(jget_config(name)), reduced(get_config(name))


def _lookup_ids(cfg, batch, offs):
    """The batch's engine-global ids, (B, G, 1)."""
    if "fields" in batch:
        return (batch["fields"] + offs[None, :].astype(np.int32))[..., None]
    ids = batch["seq"] if cfg.interaction == "self-attn-seq" else \
        np.concatenate([batch["seq"], batch["target"][:, None]], 1)
    return ids[..., None].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _carried(name, storage, shards):
    """The reference's engine, params and state (hot pages placed by its
    planner) and the port's model and engine holding the same."""
    jcfg, cfg = _cfgs(name)
    mesh = make_mesh((1, 1) if shards == 1 else (2, 4), ("data", "model"))
    jeng, offs = jrec.build_engine(jcfg, mesh, storage=storage)
    params = jprm.initialize(jrec.model_specs(jcfg, mesh),
                             jax.random.PRNGKey(0))
    jstate = jeng.init_state(jax.random.PRNGKey(1))
    batches = list(rec_batches(jcfg, B, 4, seed=5, kind="serve"))
    with mesh:
        for b in batches[:3]:
            jstate = jeng.observe(jstate,
                                  jnp.asarray(_lookup_ids(jcfg, b, offs)))
        jstate, _ = jeng.plan_and_migrate(jstate)
    model = rec.RecModel(cfg, "cpu")
    model.load_state_dict(rec.params_from_numpy(
        jax.tree.map(np.asarray, params)))
    eng, poffs = rec.build_engine(cfg, "cpu", storage=storage,
                                  n_shards=shards)
    np.testing.assert_array_equal(offs, poffs)
    assert dataclasses.asdict(eng.cfg) == dataclasses.asdict(jeng.cfg)
    state = eng.pack_state(*map(np.asarray, jeng.export_state(jstate)),
                           table=PageTable(np.asarray(jstate.page_to_shard),
                                           np.asarray(jstate.page_to_slot)))
    return (jcfg, mesh, jeng, offs, params, jstate, model, eng, state,
            batches[3])


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    j, p = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.n_sparse == j.n_sparse
    assert dataclasses.asdict(reduced(p)) == dataclasses.asdict(jreduced(j))


def test_registry_shapes_and_reduced_shapes_equal_the_reference():
    assert list_archs() == jbase.list_archs()
    # the DLRM family: the paper's RMC models and MLPerf's DLRM-DCNv2, a
    # port-only configuration the reference does not hold
    assert list_archs(assigned_only=False) == sorted(
        list_archs() + ["dlrm-dcnv2", "rmc1", "rmc2", "rmc3", "rmc4"])
    assert {k: dataclasses.asdict(v) for k, v in REC_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.REC_SHAPES.items()}
    for k, s in REC_SHAPES.items():
        assert dataclasses.asdict(reduced_shape(s)) == dataclasses.asdict(
            jbase.reduced_shape(jbase.REC_SHAPES[k]))
    from repro_torch.configs.autoint import CRITEO_CAT_VOCABS
    from repro.configs.autoint import CRITEO_CAT_VOCABS as J_VOCABS
    assert CRITEO_CAT_VOCABS == J_VOCABS
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    assert get_config("graphsage-reddit").family == "gnn"
    assert get_config("llama3.2-3b").family == "lm"
    with pytest.raises(TypeError):
        reduced(object())


def _spec_paths(arch):
    """The reference's Spec leaves at the published widths by dotted path
    (no allocation)."""
    mesh = make_mesh((1, 1), ("data", "model"))
    flat = jax.tree_util.tree_flatten_with_path(
        jrec.model_specs(jget_config(arch), mesh),
        is_leaf=lambda x: isinstance(x, jprm.Spec))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): s for path, s in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_mirrors_the_reference_at_published_widths(arch):
    """Every parameter of the reference's tree, by its dotted path, with its
    shape, at the published widths (empty tensors, a few MB)."""
    got = {n: tuple(p.shape) for n, p in
           rec.RecModel(get_config(arch), "cpu").named_parameters()}
    assert got == {k: tuple(s.shape) for k, s in _spec_paths(arch).items()}


# ------------------------------------------------------------------ lookups
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("name", CASES)
def test_lookups_bitwise_equal_the_reference(name, storage, shards):
    jcfg, mesh, jeng, offs, _, jstate, _, eng, state, batch = _carried(
        name, storage, shards)
    if name == "dcn-v2":
        assert bool((state.page_to_shard == HOT_SHARD).any())
    ids = _lookup_ids(jcfg, batch, offs)
    for mode in ("pifs", "pond"):
        with mesh:
            want = np.asarray(jax.jit(
                lambda s, i: jeng.lookup(s, i, mode=mode))(
                    jstate, jnp.asarray(ids)))
        got = eng.lookup(state, torch.as_tensor(ids), mode=mode)
        assert got.shape == (B, ids.shape[1], jcfg.embed_dim)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mode)
    # and through the model's own lookup helpers
    tb = _t(batch)
    if "fields" in batch:
        got = rec._field_lookup(eng, state, tb["fields"], offs, "pifs")
    else:
        got = rec._seq_lookup(eng, state, tb["seq"], 0, "pifs")
        ids = ids[:, :jcfg.seq_len]
    with mesh:
        want = np.asarray(jax.jit(lambda s, i: jeng.lookup(s, i))(
            jstate, jnp.asarray(ids)))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ serve and retrieval
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("name", CASES)
def test_serve_step_matches_the_reference(name, storage, shards):
    jcfg, mesh, jeng, offs, params, jstate, model, eng, state, batch = \
        _carried(name, storage, shards)
    with mesh:
        step = jax.jit(jrec.make_serve_step(jcfg, jeng, offs, mesh))
        want = np.asarray(step(params, jstate,
                               jax.tree.map(jnp.asarray, batch)))
    got = rec.make_serve_step(model, eng, offs)(state, _t(batch))
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert bool(((got > 0) & (got < 1)).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # dedup on is bitwise equal to off
    on = rec.make_serve_step(model, eng, offs, dedup="on")(state, _t(batch))
    np.testing.assert_array_equal(on.numpy(), got.numpy())


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("name", CASES)
def test_retrieval_scores_match_the_reference(name, storage, shards):
    jcfg, mesh, jeng, offs, params, jstate, model, eng, state, batch = \
        _carried(name, storage, shards)
    rng = np.random.default_rng(7)
    q = {k: v[:1] for k, v in batch.items() if k != "target"}
    q["cand_ids"] = rng.integers(0, jcfg.vocab_sizes[0],
                                 (N_CAND,)).astype(np.int32)
    with mesh:
        step = jax.jit(jrec.make_retrieval_step(jcfg, jeng, offs, mesh))
        want = np.asarray(step(params, jstate, jax.tree.map(jnp.asarray, q)))
    got = rec.make_retrieval_step(model, eng, offs)(state, _t(q))
    assert got.shape == (N_CAND,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_attention_and_layer_norm_match_the_reference():
    """_mha (causal and not, 2 heads, kv from another tensor) and _ln at
    eps 1e-6 on their own, within 1e-5."""
    rng = np.random.default_rng(0)
    d, da = 12, 8
    w = {k: rng.normal(size=s).astype(np.float32) for k, s in
         (("wq", (d, da)), ("wk", (d, da)), ("wv", (d, da)),
          ("wo", (da, d)))}
    x = rng.normal(size=(3, 5, d)).astype(np.float32)
    kv = rng.normal(size=(3, 7, d)).astype(np.float32)
    p = rec.Attention(d, da, d, "cpu")
    p.load_state_dict({k: torch.as_tensor(v) for k, v in w.items()})
    jw = jax.tree.map(jnp.asarray, w)
    with torch.no_grad():
        for causal, kvs in ((True, None), (False, None), (False, kv)):
            got = rec._mha(p, torch.as_tensor(x), 2, causal,
                           None if kvs is None else torch.as_tensor(kvs))
            want = jrec._mha(jw, jnp.asarray(x), 2, causal,
                             None if kvs is None else jnp.asarray(kvs))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        g, b = rng.normal(size=(d,)), rng.normal(size=(d,))
        got = rec._ln(torch.as_tensor(x), torch.as_tensor(g, dtype=torch.float32),
                      torch.as_tensor(b, dtype=torch.float32))
        want = jrec._ln(jnp.asarray(x), jnp.asarray(g, jnp.float32),
                        jnp.asarray(b, jnp.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------- init rule
@pytest.mark.parametrize("arch", ARCHS)
def test_init_rule_follows_the_reference_specs(arch):
    """Each parameter's rule is its reference Spec's init (scale 0.02 for
    pos_emb, 1/sqrt(fan_in) for the rest), and the drawn values follow
    it: gains ones, biases zeros, pos_emb std ~ 0.02, weights std ~
    1/sqrt(fan_in) (within five standard errors of a sample std)."""
    specs = _spec_paths(arch)
    model = initialize(rec.RecModel(get_config(arch), "cpu"),
                       torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        s = specs[name]
        rule = init_rule(name)
        if s.init in ("ones", "zeros"):
            assert rule == s.init, name
            assert bool((p == (1.0 if rule == "ones" else 0.0)).all()), name
            continue
        assert s.init == "normal", name
        if s.scale is not None and name.endswith("pos_emb"):
            assert rule == "pos" and s.scale == 0.02
            want = 0.02
        else:
            assert rule == "normal", name
            fan_in = p.shape[-2] if p.dim() >= 2 else max(p.shape[-1], 1)
            want = s.scale if s.scale is not None else 1 / math.sqrt(fan_in)
        # five standard errors of a sample std over numel draws
        assert abs(float(p.detach().std()) / want - 1) < \
            5 / math.sqrt(2 * p.numel()), name


def test_dlrm_draws_unchanged():
    """The rule draws a DLRM's weights as before it existed: biases zero
    (no draw), every other parameter normal / sqrt(fan_in) in registration
    order on one generator."""
    cfg = reduced(get_config("rmc1"))
    got = initialize(dlrm.DLRM(cfg, "cpu"), torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    for name, p in got.named_parameters():
        if name.endswith("_b"):
            assert bool((p == 0).all()), name
            continue
        fan_in = p.shape[-2] if p.dim() >= 2 else max(p.shape[-1], 1)
        want = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
        assert torch.equal(p.detach(), want), name
