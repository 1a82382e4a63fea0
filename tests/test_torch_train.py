"""Training in the port against the reference: the autograd wrappers of
the train path's kernels, the DLRM and recsys train steps, the training
launcher, the example and the data pipeline.

Tolerances:
- Backwards (``masked_sls``, ``masked_sls_dedup``, ``dot_interaction``):
  against torch autograd through the plain forward and against
  ``jax.grad`` of the reference, rtol 1e-5 / atol 1e-6.  The gradient of
  a gather is a scatter-add, and each package sums duplicate rows in its
  own order; the interaction's transpose is ``(G + G^T) @ feats`` here,
  two products in autograd.
- Train steps, with the reference's weights, tables and page table
  carried across and zero optimizer states: losses within rtol 1e-5,
  parameters and both tiers within atol 1e-5 / rtol 1e-4 after 1 and 3
  steps.  Lookups are bitwise equal, but the MLP and interaction products
  reduce in another order, the scatter-adds as above, and adam divides by
  ``sqrt(v)`` where v is small.  No convergence is tested.
- Gather-once (dedup on) against off in the port: bitwise, forward and
  backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import sls as jsls
from repro.distributed.sharding import make_mesh
from repro.kernels import ref as jref
from repro.models import dlrm as jdlrm
from repro.models import params as jprm
from repro.models import recsys as jrec
from repro.optim import optimizers as jopt

from repro_torch.configs import get_config, reduced
from repro_torch.core import sls as core_sls
from repro_torch.core.paging import PageTable
from repro_torch.data import pipeline, synth
from repro_torch.examples import train_dlrm as train_example
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import dlrm, recsys as rec
from repro_torch.models.params import initialize
from repro_torch.optim import optimizers as opt

RTOL, ATOL = 1e-5, 1e-6


def _sls_case(seed, N=11, L=5, V=40, D=6, owned=True, weights=True):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, 8, (N, L)).astype(np.int32)   # many duplicates
    own = rng.random((N, L)) < 0.7 if owned else None
    w = rng.normal(size=(N, L)).astype(np.float32) if weights else None
    g = rng.normal(size=(N, D)).astype(np.float32)
    return table, idx, own, w, g


def _t(x):
    return None if x is None else torch.as_tensor(x)


@pytest.mark.parametrize("owned,weights", [(True, True), (True, False),
                                           (False, True), (False, False)])
def test_masked_sls_backward(owned, weights):
    table, idx, own, w, g = _sls_case(0, owned=owned, weights=weights)
    t = torch.tensor(table, requires_grad=True)
    out = ops.masked_sls(t, _t(idx), _t(own), _t(w))
    (gt,) = torch.autograd.grad(out, t, _t(g))
    # torch autograd through the plain forward
    t2 = torch.tensor(table, requires_grad=True)
    out2 = ref._fixed_order_masked_sls(t2, _t(idx), _t(own), _t(w))
    (ga,) = torch.autograd.grad(out2, t2, _t(g))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  out2.detach().numpy())
    np.testing.assert_allclose(gt.numpy(), ga.numpy(), rtol=RTOL, atol=ATOL)
    # jax.grad of the reference's jnp lookup
    jown = jnp.ones(idx.shape, bool) if own is None else jnp.asarray(own)

    def f(tb):
        o = jsls.masked_partial_sls_dense(
            tb, jnp.asarray(idx), jown, None if w is None else jnp.asarray(w),
            impl="jnp")
        return jnp.sum(o * jnp.asarray(g))
    gj = np.asarray(jax.grad(f)(jnp.asarray(table)))
    np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shards", [1, 3])
def test_masked_sls_dedup_backward_equals_per_entry(shards):
    """Through ``core.sls`` (S stacked shards in one call): gather-once and
    per-entry give the same pooled rows and gradients, bitwise, and match
    the reference's jnp dedup path within the stated tolerance."""
    table, idx, own, w, g = _sls_case(1, N=9, L=4, V=30)
    S = shards
    rng = np.random.default_rng(3)
    own_s = rng.random((S, 9, 4)) < 0.5 if S > 1 else own[None]
    big = np.concatenate([table] * S)
    outs, grads = [], []
    for dedup in (False, True):
        t = torch.tensor(big, requires_grad=True)
        out = core_sls.masked_partial_sls_dense(t, _t(idx), _t(own_s),
                                                _t(w), dedup=dedup)
        gS = np.stack([g] * S)
        (gt,) = torch.autograd.grad(out, t, _t(gS))
        outs.append(out.detach().numpy())
        grads.append(gt.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(grads[0], grads[1])
    if S == 1:
        def f(tb):
            o = jsls.masked_partial_sls_dense(
                tb, jnp.asarray(idx), jnp.asarray(own), jnp.asarray(w),
                impl="jnp", dedup=True)
            return jnp.sum(o * jnp.asarray(g))
        gj = np.asarray(jax.grad(f)(jnp.asarray(table)))
        np.testing.assert_allclose(grads[1], gj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_backward(self_interaction):
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(5, 7, 6)).astype(np.float32)
    F = 7
    P = F * (F - 1) // 2 + (F if self_interaction else 0)
    g = rng.normal(size=(5, P)).astype(np.float32)
    x = torch.tensor(feats, requires_grad=True)
    out = ops.dot_interaction(x, self_interaction)
    (gx,) = torch.autograd.grad(out, x, _t(g))
    x2 = torch.tensor(feats, requires_grad=True)
    (ga,) = torch.autograd.grad(
        ref.dot_interaction_ref(x2, self_interaction), x2, _t(g))
    np.testing.assert_allclose(gx.numpy(), ga.numpy(), rtol=RTOL, atol=ATOL)
    gj = np.asarray(jax.grad(lambda f: jnp.sum(
        jref.dot_interaction_ref(f, self_interaction) * jnp.asarray(g)))(
            jnp.asarray(feats)))
    np.testing.assert_allclose(gx.numpy(), gj, rtol=RTOL, atol=ATOL)


def test_gradients_are_refused_where_there_is_no_backward():
    cfg = reduced(get_config("rmc1"))
    eng, offs = dlrm.build_engine(cfg, "cpu", storage="int8")
    model = initialize(dlrm.DLRM(cfg, "cpu"),
                       torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="not differentiable"):
        dlrm.make_train_step(model, eng, opt.adam(), opt.rowwise_adagrad())
    with pytest.raises(RuntimeError):
        eng.init_state(torch.Generator().manual_seed(1)).cold \
            .requires_grad_(True)
    # the fused front end (one shard: fused; four: fused_tp) has none
    for S in (1, 4):
        eng, offs = dlrm.build_engine(cfg, "cpu", n_shards=S)
        st = eng.init_state(torch.Generator().manual_seed(1))
        b = next(synth.dlrm_batches(cfg, 4, 1))
        idx = torch.as_tensor(b["indices"])
        x = torch.randn(4, cfg.emb_dim, requires_grad=True)
        with pytest.raises(RuntimeError, match="no backward"):
            eng.lookup_interact(st, idx, x, front_end="fused")
        st.hot.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            eng.lookup_interact(st, idx, x.detach(), front_end="fused")
        with torch.no_grad():
            eng.lookup_interact(st, idx, x, front_end="fused")
        st.hot.requires_grad_(False)
    table, idx_np, own, w, _ = _sls_case(2)
    with pytest.raises(NotImplementedError, match="weights"):
        ops.masked_sls(torch.tensor(table, requires_grad=True), _t(idx_np),
                       _t(own), torch.tensor(w, requires_grad=True))


# ---------------------------------------------------------------- DLRM


def _carry_dlrm(S, mode, dedup):
    mesh = make_mesh((1, S), ("data", "model"))
    jcfg = jreduced(jget_config("rmc1"))
    cfg = reduced(get_config("rmc1"))
    jeng, _ = jdlrm.build_engine(jcfg, mesh, dedup=dedup)
    params = jprm.initialize(jdlrm.model_specs(jcfg, mesh),
                             jax.random.PRNGKey(0))
    js = jeng.init_state(jax.random.PRNGKey(1))
    batches = list(synth.dlrm_batches(cfg, 16, 5, seed=3))
    for b in batches[:2]:              # a hot tier placed from a profile
        js = jeng.observe(js, jnp.asarray(b["indices"]))
    js, _ = jeng.plan_and_migrate(js)
    model = dlrm.DLRM(cfg, "cpu")
    model.load_state_dict(dlrm.params_from_numpy(
        jax.tree.map(np.asarray, params)))
    eng, _ = dlrm.build_engine(cfg, "cpu", n_shards=S, dedup=dedup)
    st = eng.pack_state(*map(np.asarray, jeng.export_state(js)),
                        table=PageTable(np.asarray(js.page_to_shard),
                                        np.asarray(js.page_to_slot)))
    return mesh, jcfg, jeng, params, js, model, eng, st, batches[2:]


def _check_tiers_params(eng, st, jeng, js, pparams, jparams):
    np.testing.assert_allclose(eng.export_state(st)[1].numpy(),
                               np.asarray(jeng.export_state(js)[1]),
                               rtol=1e-4, atol=1e-5)
    for k, v in pparams.items():
        np.testing.assert_allclose(v.detach().numpy(), jparams[k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("S,mode,dedup", [(1, "pifs", "off"),
                                          (4, "pifs", "off"),
                                          (1, "pond", "off"),
                                          (4, "pond", "off"),
                                          (1, "pifs", "on")])
def test_dlrm_train_steps_match_reference(S, mode, dedup):
    mesh, jcfg, jeng, params, js, model, eng, st, batches = \
        _carry_dlrm(S, mode, dedup)
    jo, jeo = jopt.adam(1e-3), jopt.rowwise_adagrad(5e-2)
    po, peo = opt.adam(1e-3), opt.rowwise_adagrad(5e-2)
    jos, jeos = jo.init(params), jeo.init({"cold": js.cold, "hot": js.hot})
    pos = po.init(dict(model.named_parameters()))
    peos = peo.init({"cold": st.cold, "hot": st.hot})
    pstep = dlrm.make_train_step(model, eng, po, peo, mode=mode)
    with mesh:
        jstep = jax.jit(jdlrm.make_train_step(jcfg, jeng, mesh, jo, jeo,
                                              mode=mode))
        for i, b in enumerate(batches):
            params, js, jos, jeos, jm = jstep(params, js, jos, jeos,
                                              jax.tree.map(jnp.asarray, b))
            st, pos, peos, pm = pstep(st, pos, peos,
                                      {k: torch.as_tensor(v)
                                       for k, v in b.items()})
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                       rtol=RTOL)
            if i in (0, 2):                       # after 1 and 3 steps
                jp = {f"{t}.{n}": np.asarray(v)
                      for t in ("bottom", "top")
                      for n, v in params[t].items()}
                if "bot_proj" in params:
                    jp["bot_proj"] = np.asarray(params["bot_proj"])
                _check_tiers_params(eng, st, jeng, js,
                                    dict(model.named_parameters()), jp)
    assert not st.cold.requires_grad and not st.hot.requires_grad
    assert int(pos["step"]) == 3


def test_trained_state_keeps_serving_and_updating():
    cfg = reduced(get_config("rmc1"))
    out = launch_train.train_dlrm(cfg, 6, 8, replan_every=3, log_every=100,
                                  device="cpu")
    state = out["state"]
    eng, _ = dlrm.build_engine(cfg, "cpu")
    model = initialize(dlrm.DLRM(cfg, "cpu"),
                       torch.Generator().manual_seed(0))
    b = {k: torch.as_tensor(v)
         for k, v in next(synth.dlrm_batches(cfg, 8, 1, seed=9)).items()}
    s = dlrm.make_serve_step(model, eng)(state, b)
    assert bool(((s > 0) & (s < 1)).all())
    before = eng.to_dense(state).clone()
    eng.apply_deltas(state, np.array([3, -1]), np.ones((2, cfg.emb_dim),
                                                       np.float32))
    after = eng.to_dense(state)
    torch.testing.assert_close(after[3], before[3] + 1.0)
    assert torch.equal(after[4:], before[4:])


# -------------------------------------------------------------- recsys


@pytest.mark.parametrize("arch", ["sasrec", "bst", "autoint", "dcn-v2"])
def test_recsys_train_steps_match_reference(arch):
    mesh = make_mesh((1, 1), ("data", "model"))
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jeng, offs = jrec.build_engine(jcfg, mesh)
    params = jprm.initialize(jrec.model_specs(jcfg, mesh),
                             jax.random.PRNGKey(0))
    js = jeng.init_state(jax.random.PRNGKey(1))
    js, _ = jeng.plan_and_migrate(js)
    model = rec.RecModel(cfg, "cpu")
    model.load_state_dict(rec.params_from_numpy(
        jax.tree.map(np.asarray, params)))
    eng, _ = rec.build_engine(cfg, "cpu")
    st = eng.pack_state(*map(np.asarray, jeng.export_state(js)),
                        table=PageTable(np.asarray(js.page_to_shard),
                                        np.asarray(js.page_to_slot)))
    jo, jeo = jopt.adam(1e-3), jopt.rowwise_adagrad(5e-2)
    po, peo = opt.adam(1e-3), opt.rowwise_adagrad(5e-2)
    jos, jeos = jo.init(params), jeo.init({"cold": js.cold, "hot": js.hot})
    pos = po.init(dict(model.named_parameters()))
    peos = peo.init({"cold": st.cold, "hot": st.hot})
    pstep = rec.make_train_step(model, eng, offs, po, peo)
    with mesh:
        jstep = jax.jit(jrec.make_train_step(jcfg, jeng, offs, mesh, jo,
                                             jeo))
        for i, b in enumerate(synth.rec_batches(cfg, 8, 3, seed=3)):
            params, js, jos, jeos, jm = jstep(params, js, jos, jeos,
                                              jax.tree.map(jnp.asarray, b))
            st, pos, peos, pm = pstep(st, pos, peos,
                                      {k: torch.as_tensor(v)
                                       for k, v in b.items()})
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                       rtol=RTOL)
            if i in (0, 2):
                _check_tiers_params(
                    eng, st, jeng, js, dict(model.named_parameters()),
                    {k: v.numpy() for k, v in rec.params_from_numpy(
                        jax.tree.map(np.asarray, params)).items()})


def test_recsys_int8_train_step_raises():
    cfg = reduced(get_config("dcn-v2"))
    eng, offs = rec.build_engine(cfg, "cpu", storage="int8")
    model = rec.RecModel(cfg, "cpu")
    with pytest.raises(TypeError, match="not differentiable"):
        rec.make_train_step(model, eng, offs, opt.adam(),
                            opt.rowwise_adagrad())


# ------------------------------------------- launcher, example, pipeline


@pytest.mark.parametrize("arch", ["rmc1", "sasrec", "dcn-v2"])
def test_train_cli_on_cpu(arch, capsys):
    out = launch_train.main(["--arch", arch, "--device", "cpu",
                             "--steps", "8", "--batch", "8"])
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["final_loss"])
    assert "done in" in capsys.readouterr().out


def test_train_cli_refuses_item17_and_needs_a_card():
    """Every LM id and graphsage-reddit train now (their losses are held
    in test_torch_lm_train.py and test_torch_gnn.py)."""
    for arch in ("nemotron-4-340b", "graphsage-reddit"):
        out = launch_train.main(["--arch", arch, "--device", "cpu",
                                 "--steps", "2", "--batch", "2", "--seq",
                                 "8"])
        assert np.isfinite(out["final_loss"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_train.main(["--arch", "rmc1", "--steps", "2"])


def test_train_dlrm_example_survives_its_failure(capsys):
    """The example at its own defaults (reduced RMC1, 200 steps of 64)."""
    out = train_example.main(["--device", "cpu"])
    rep = out["report"]
    assert rep.steps_done == 200 and rep.restarts == 1
    assert out["losses"][-1] < out["losses"][0]
    assert "injected failure at step 100 survived" in capsys.readouterr().out


def test_launcher_replans_during_training():
    cfg = reduced(get_config("rmc1"))
    out = launch_train.train_dlrm(cfg, 8, 16, replan_every=4,
                                  log_every=100, device="cpu", n_shards=4)
    assert len(out["losses"]) == 8
    st = out["state"]
    assert bool((st.page_to_shard == -1).any())        # a hot tier placed
    assert float(st.counts.sum()) > 0


def test_prefetcher_and_shard_batch():
    cfg = reduced(get_config("rmc1"))
    want = list(synth.dlrm_batches(cfg, 4, 5, seed=1))
    got = list(pipeline.Prefetcher(synth.dlrm_batches(cfg, 4, 5, seed=1),
                                   depth=2, device="cpu"))
    assert len(got) == 5
    for a, b in zip(got, want):
        for k in b:
            assert torch.is_tensor(a[k])
            np.testing.assert_array_equal(a[k].numpy(), b[k])
    raw = list(pipeline.Prefetcher(iter(want)))
    assert raw[0] is want[0]
    placed = pipeline.shard_batch(want[0], "cpu")
    assert placed["indices"].dtype == torch.int32

    def broken():
        yield want[0]
        raise ValueError("generator failed")
    it = pipeline.Prefetcher(broken(), device="cpu")
    next(it)
    with pytest.raises(ValueError, match="generator failed"):
        next(it)


@pytest.mark.cuda
def test_train_step_kernel_path_matches_plain_on_the_card():
    """On the card: one DLRM train step of the kernel path against the
    plain path's from the same seeds (loss within 1e-5 relative, tiers
    within 1e-5 + 1e-4 relative: the interaction reduces in another order;
    later steps are not compared, as adam moves a weight whose gradient is
    at the noise level by 2 lr either way), and three DCN-v2 steps bitwise
    (every lookup an L = 1 bag of weight 1, one deterministic backward)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    for arch, steps in (("rmc1", 1), ("dcn-v2", 3)):
        cfg = reduced(get_config(arch))
        fn = (launch_train.train_dlrm if arch == "rmc1"
              else launch_train.train_rec)
        runs = [fn(cfg, steps, 16, device="cuda", impl=impl, log_every=100)
                for impl in ("cuda", "torch")]
        a, b = (r["state"] for r in runs)
        if arch == "dcn-v2":
            assert runs[0]["losses"] == runs[1]["losses"]
            assert torch.equal(a.cold, b.cold) and torch.equal(a.hot, b.hot)
        else:
            np.testing.assert_allclose(runs[0]["losses"], runs[1]["losses"],
                                       rtol=1e-5)
            for x, y in ((a.cold, b.cold), (a.hot, b.hot)):
                torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
