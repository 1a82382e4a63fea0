"""The port's LM training (``repro_torch.models.transformer``: ``loss_fn``,
``make_train_step``; the differentiable ``models.attention.flash_attention``;
``optim.optimizers.adafactor``; ``launch.train.train_lm``) against
``repro.models.transformer`` on the CPU.

The reference runs on ``make_mesh((1, 1))`` under ``jax.jit``; its weights
are drawn with its PRNG and carried across as numpy leaves; batches come
from ``lm_batches``.  Gradients are compared leaf by leaf by their
relative Frobenius error ``|got - want| / |want|``.

Tolerances.
- fp32: the loss within 1e-6 relative, every gradient leaf within 1e-5
  (measured ~2e-6: the two packages reduce in other orders), parameters
  after an adafactor step within 1e-6 absolute (the update is 3e-3 x a
  clipped direction; measured ~1e-9).
- bf16: every product, norm and residual rounds to bf16 in both, at other
  points; the loss within 2^-7 relative, the whole gradient tree within
  5e-2 and each leaf within 0.25 (measured: 1.5e-2 and 0.19, the largest
  in deepseek's MTP MoE block, where a token near a tie between two
  experts can pick the other in one package), parameters after a step
  within 2^-7 absolute plus 2^-7 relative (one bf16 rounding of the
  update).
- flash attention's backward: fp32 gradients within 1e-5 relative
  Frobenius of ``jax.grad`` of the reference's ``flash_attention``.
- adafactor: parameters and factors within 1e-6 relative over 3 steps.
- remat: the three modes give bitwise-equal gradients on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.distributed.sharding import make_mesh
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import params as jprm
from repro.models import transformer as jtr
from repro.optim import optimizers as jopt

from repro_torch.configs import get_config, reduced
from repro_torch.data.synth import lm_batches
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tr
from repro_torch.optim import optimizers as opt

LM_ARCHS = ["llama3.2-3b", "granite-moe-1b-a400m", "deepseek-v3-671b",
            "deepseek-67b", "nemotron-4-340b"]
MESH = make_mesh((1, 1), ("data", "model"))
B, S = 4, 32
GRAD_TOL = {"float32": dict(leaf=1e-5, tree=1e-5, loss=1e-6),
            "bfloat16": dict(leaf=0.25, tree=5e-2, loss=2 ** -7)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jflat(tree):
    return {".".join(str(k.key) for k in path): _f32(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _carried(arch, dtype="float32", seed=0):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype=dtype)
    pcfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    jp = jprm.initialize(jtr.model_specs(jcfg, MESH),
                         jax.random.PRNGKey(seed))
    pp = tr.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    return jcfg, pcfg, jp, pp


def _batch(cfg, seed=0, batch=B, seq=S):
    return next(lm_batches(cfg, batch, seq, 1, seed=seed))


def _grads(pp, b, cfg, remat="dots"):
    paths, leaves = zip(*tr.tree_leaves(pp))
    alias = [p.detach().requires_grad_() for p in leaves]
    loss = tr.loss_fn(tr._tree(paths, alias), b["tokens"], b["labels"], cfg,
                      remat=remat)
    return loss, dict(zip(paths, torch.autograd.grad(loss, alias)))


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_grads(got, want, tol):
    assert got.keys() == want.keys()
    num = den = 0.0
    for k in want:
        g = _f32(got[k])
        assert _rel(g, want[k]) <= tol["leaf"], (k, _rel(g, want[k]))
        num += float(np.sum((g - want[k]) ** 2))
        den += float(np.sum(want[k] ** 2))
    assert (num / den) ** 0.5 <= tol["tree"]


# ------------------------------------------------------------ loss / grads
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_equal_the_reference(arch, dtype):
    jcfg, pcfg, jp, pp = _carried(arch, dtype)
    b = _batch(pcfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, t, y: jtr.loss_fn(p, t, y, jcfg, MESH)))(
        jp, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    loss, grads = _grads(pp, b, pcfg)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=GRAD_TOL[dtype]["loss"])
    _assert_grads(grads, _jflat(jg), GRAD_TOL[dtype])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_modes_give_equal_grads(arch):
    _, pcfg, _, pp = _carried(arch)
    b = _batch(pcfg)
    ref_loss, ref = _grads(pp, b, pcfg, remat="none")
    for remat in ("dots", "full"):
        loss, got = _grads(pp, b, pcfg, remat=remat)
        assert torch.equal(loss, ref_loss)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (remat, k)
    with pytest.raises(ValueError, match="remat"):
        tr.make_train_step(pcfg, opt.adafactor(), remat="some")


# ------------------------------------------------------------- train steps
def _step_case(arch, dtype, accum):
    jcfg, pcfg, jp, pp = _carried(arch, dtype)
    b = _batch(pcfg)
    jo = jopt.adafactor(lr=3e-3)
    jstep = jax.jit(jtr.make_train_step(jcfg, MESH, jo, accum=accum))
    jp2, jo2, jm = jstep(jp, jo.init(jp), {k: jnp.asarray(v)
                                           for k, v in b.items()})
    po = opt.adafactor(lr=3e-3)
    pstate = po.init(pp)
    pp2, pstate2, pm = tr.make_train_step(pcfg, po, accum=accum)(
        pp, pstate, b)
    assert pp2 is pp and pstate2 is pstate               # in place
    if dtype == "float32":
        ptol, mtol = dict(rtol=0, atol=1e-6), 1e-6
    else:
        ptol, mtol = dict(rtol=2 ** -7, atol=2 ** -7), 2 ** -7
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=mtol)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]),
                               rtol=GRAD_TOL[dtype]["tree"])
    want = _jflat(jp2)
    for k, v in tr.tree_leaves(pp2):
        assert v.dtype == tr.cfg_dtype(pcfg) or k.endswith("router")
        np.testing.assert_allclose(_f32(v), want[k], err_msg=k, **ptol)
    if dtype == "float32":
        jv = _jflat(jo2["v"])
        for k, v in opt._leaves(pstate2["v"]):
            key = k.replace("/", ".")
            assert _rel(_f32(v), jv[key]) <= 1e-5, key
    assert int(pstate2["step"]) == int(jo2["step"]) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_adafactor_train_step_equals_the_reference(arch, dtype):
    _step_case(arch, dtype, accum=1)


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in LM_ARCHS]
                         + [("llama3.2-3b", "bfloat16")])
def test_accum2_train_step_equals_the_reference(arch, dtype):
    """Two microbatches of 2 rows; bf16 accumulates in bf16 in both."""
    _step_case(arch, dtype, accum=2)


def test_accum_splits_consecutive_rows_and_refuses_a_ragged_batch():
    """fp32: accum=2 equals the mean of the two halves' gradients."""
    _, pcfg, _, pp = _carried("llama3.2-3b")
    b = _batch(pcfg)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in b.items()}
              for i in range(2)]
    g = [_grads(pp, h, pcfg)[1] for h in halves]

    class Capture:
        init = staticmethod(lambda params: {})

        @staticmethod
        def update(grads, state, params):
            state["grads"] = dict(tr.tree_leaves(grads))
            return params, state
    st = {}
    tr.make_train_step(pcfg, Capture, accum=2)(pp, st, b)
    for k in g[0]:
        torch.testing.assert_close(st["grads"][k], (g[0][k] + g[1][k]) / 2,
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="microbatches"):
        tr.make_train_step(pcfg, Capture, accum=3)(pp, st, b)


# ---------------------------------------------------- MTP, MoE aux, xent
def test_mtp_loss_equals_the_reference():
    """deepseek-v3 reduced (mtp_depth 1, an MoE MTP block): the loss and
    its gradients with respect to the hidden state and the MTP leaves."""
    jcfg, pcfg, jp, pp = _carried("deepseek-v3-671b")
    assert pcfg.mtp_depth == 1
    b = _batch(pcfg)
    h = np.random.default_rng(3).normal(
        size=(B, S, pcfg.d_model)).astype(np.float32)
    jl, (jgp, jgh) = jax.jit(jax.value_and_grad(
        lambda p, x: jtr._mtp_loss(p, x, jnp.asarray(b["tokens"]),
                                   jnp.asarray(b["labels"]), jcfg, MESH),
        argnums=(0, 1)))(jp, jnp.asarray(h))
    paths, leaves = zip(*tr.tree_leaves(pp))
    alias = [p.detach().requires_grad_() for p in leaves]
    x = torch.from_numpy(h).requires_grad_()
    loss = tr._mtp_loss(tr._tree(paths, alias), x,
                        torch.from_numpy(b["tokens"]),
                        torch.from_numpy(b["labels"]), pcfg)
    grads = torch.autograd.grad(loss, [x] + alias, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    assert _rel(_f32(grads[0]), _f32(jgh)) <= 1e-5
    want = _jflat(jgp)
    for k, g in zip(paths, grads[1:]):
        if k.startswith("mtp.") or k in ("embed", "head"):
            assert _rel(_f32(g), want[k]) <= 1e-5, k
        else:
            assert g is None and not want[k].any(), k


def test_moe_aux_loss_and_its_gradient_equal_the_reference():
    """granite reduced's MoE layer: the output, the aux loss, and the
    gradients of sum(out * w) + aux with respect to x and every expert
    leaf (the router through the softmax, gates and aux)."""
    jcfg, pcfg, jp, pp = _carried("granite-moe-1b-a400m")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, pcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["moe_layers"]["moe"])
    dp, tp = jtr._axes(MESH)

    def jf(p, x):
        out, aux = jmoe.moe_apply(p, x, jcfg, MESH, dp, tp)
        return jnp.sum(out * w) + aux, (out, aux)
    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jlp, jnp.asarray(x))
    plp = {k: v[0].detach().requires_grad_()
           for k, v in pp["moe_layers"]["moe"].items()}
    px = torch.from_numpy(x).requires_grad_()
    out, aux = moe_mod.moe_apply(plp, px, pcfg)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                [px] + list(plp.values()))
    np.testing.assert_allclose(_f32(out), _f32(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    assert float(aux.detach()) > 0
    assert _rel(_f32(grads[0]), _f32(jgx)) <= 1e-5
    for (k, _), g in zip(plp.items(), grads[1:]):
        assert _rel(_f32(g), _f32(jgp[k])) <= 1e-5, k
    # the aux loss alone reaches the router (probs.mean), not the experts
    g_aux = torch.autograd.grad(moe_mod.moe_apply(plp, px, pcfg)[1],
                                [plp["router"], plp["w_up"]],
                                allow_unused=True)
    jga = jax.jit(jax.grad(lambda p: jmoe.moe_apply(
        p, jnp.asarray(x), jcfg, MESH, dp, tp)[1]))(jlp)
    assert _rel(_f32(g_aux[0]), _f32(jga["router"])) <= 1e-5
    assert g_aux[1] is None and not _f32(jga["w_up"]).any()


def test_xent_with_a_label_outside_the_vocab():
    """Labels -1 and V score gold = 0 in both; the value and its
    gradient."""
    rng = np.random.default_rng(5)
    V = 40
    lg = rng.normal(size=(2, 6, V)).astype(np.float32) * 3
    lab = rng.integers(0, V, (2, 6)).astype(np.int32)
    lab[0, 1], lab[1, 4], lab[1, 5] = -1, V, V + 7
    jl, jgrad = jax.value_and_grad(
        lambda a: jtr._xent_vocab_parallel(a, jnp.asarray(lab), MESH))(
        jnp.asarray(lg))
    t = torch.from_numpy(lg).requires_grad_()
    loss = tr._xent_vocab_parallel(t, torch.from_numpy(lab))
    (g,) = torch.autograd.grad(loss, [t])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(g[0, 0].sum()), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(g[1, 4].sum()), 1 / 12, rtol=1e-5)


# --------------------------------------------------------- flash backward
FLASH_CASES = [
    # (sq, skv, causal, q_offset, q_chunk, kv_chunk, tile_rows)
    (32, 32, True, 0, 8, 16, None),
    (32, 32, False, 0, 8, 8, None),
    (16, 48, True, 32, 8, 16, None),     # decode-like offset: all keys seen
    (24, 32, True, -8, 8, 16, None),     # rows 0-7 see no key: zero grad
    (40, 40, True, 0, 8, 8, 3),          # groups of 3 q chunks: 3, 3, 3, 1
    (40, 40, False, 0, 8, 20, 2),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_equals_jax_grad(case, monkeypatch):
    sq, skv, causal, q_offset, qc, kc, tile_rows = case
    b, H, h, dv = 2, 3, 8, 6
    if tile_rows is not None:       # tile_rows q chunks share one tile
        monkeypatch.setattr(attn, "TILE_BYTES", 4 * b * H * qc * kc
                            * tile_rows)
        assert len(attn._groups(b, H, sq, qc, kc)) == -(-sq // (qc
                                                               * tile_rows))
    rng = np.random.default_rng(sq + skv + q_offset)
    q, k = (rng.normal(size=(b, n, H, h)).astype(np.float32)
            for n in (sq, skv))
    v = rng.normal(size=(b, skv, H, dv)).astype(np.float32)
    w = rng.normal(size=(b, sq, H, dv)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc, q_offset=q_offset,
              scale=0.3)

    def jf(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, **kw) * w)
    jgrads = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attn.flash_attention(*ts, **kw)
    with torch.no_grad():
        plain = attn.flash_attention(*[t.detach() for t in ts], **kw)
    assert torch.equal(out.detach(), plain)       # one forward, both ways
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for g, jg in zip(grads, jgrads):
        assert _rel(g.numpy(), np.asarray(jg)) <= 1e-5
    if q_offset < 0:
        assert not grads[0][:, :-q_offset].any()
        assert not out[:, :-q_offset].any()


def test_flash_backward_bf16_and_plain_softmax():
    """bf16 inputs: gradients in bf16, within 2^-6 relative of autograd
    through an unchunked fp32 masked softmax."""
    rng = np.random.default_rng(9)
    b, s, H, h = 1, 64, 2, 16
    q, k, v, w = (torch.from_numpy(rng.normal(size=(b, s, H, h)).astype(
        np.float32)) for _ in range(4))
    ts = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    out = attn.flash_attention(*ts, q_chunk=16, kv_chunk=32)
    grads = torch.autograd.grad((out.float() * w).sum(), ts)
    f32 = [t.detach().float().requires_grad_() for t in ts]
    sc = torch.einsum("bqhd,bkhd->bhqk", f32[0], f32[1]) * h ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), -1)
    ref = torch.einsum("bhqk,bkhd->bqhd", p, f32[2])
    want = torch.autograd.grad((ref * w).sum(), f32)
    for g, wg in zip(grads, want):
        assert g.dtype == torch.bfloat16
        assert _rel(_f32(g), _f32(wg)) <= 2 ** -6


# ---------------------------------------------------------------- adafactor
def test_adafactor_equals_the_reference_over_three_steps():
    """Factored (both trailing dims >= 128, a stacked 3-D leaf too) and
    unfactored leaves (vectors, a narrow matrix), fp32 and bf16."""
    rng = np.random.default_rng(6)
    shapes = {"mat": (160, 130), "stack": (2, 128, 144), "narrow": (200, 64),
              "vec": (300,), "bf": (128, 128)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v, jnp.bfloat16 if k == "bf" else jnp.float32)
               for k, v in params.items()}
    pparams = {k: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if k == "bf" else torch.float32)
        for k, v in params.items()}
    jo, po = jopt.adafactor(lr=3e-2), opt.adafactor(lr=3e-2)
    js, ps = jo.init(jparams), po.init(pparams)
    assert set(ps["v"]["mat"]) == {"vr", "vc"}
    assert tuple(ps["v"]["stack"]["vc"].shape) == (2, 144)
    assert set(ps["v"]["narrow"]) == set(ps["v"]["vec"]) == {"v"}
    for t in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) * (t + 1)
             for k, s in shapes.items()}
        jparams, js = jax.jit(jo.update)(
            {k: jnp.asarray(v, jparams[k].dtype) for k, v in g.items()},
            js, jparams)
        po.update({k: torch.from_numpy(v).to(pparams[k].dtype)
                   for k, v in g.items()}, ps, pparams)
        for k in shapes:
            np.testing.assert_allclose(_f32(pparams[k]), _f32(jparams[k]),
                                       rtol=1e-6 if k != "bf" else 2 ** -7,
                                       atol=1e-7, err_msg=f"{k} step {t}")
        for k, v in opt._leaves(ps["v"]):
            a, b_ = k.split("/")
            np.testing.assert_allclose(_f32(v), _f32(js["v"][a][b_]),
                                       rtol=1e-6, err_msg=k)
    assert int(ps["step"]) == 3
    assert opt.get_optimizer("adafactor", lr=0.1).init(pparams)["step"] == 0


# --------------------------------------------------------- train_lm, CLI
def test_train_lm_loss_falls_and_a_resumed_run_ends_bit_for_bit(tmp_path):
    """Reduced granite (bf16, MoE): loss falls over 8 steps on one
    repeated batch; 4 steps with checkpoints against 2 steps, then the
    run continued from its checkpoint to 4: the last checkpoints' leaves
    are equal byte for byte."""
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    b = next(lm_batches(cfg, 2, 32, 1))
    params = tr.init_params(cfg, seed=0, device="cpu")
    o = opt.adafactor(lr=3e-3)
    st = o.init(params)
    step = tr.make_train_step(cfg, o)
    losses = [float(step(params, st, b)[2]["loss"]) for _ in range(8)]
    assert losses[-1] < losses[0]
    out = launch_train.train_lm(cfg, 2, 2, 32, device="cpu")
    assert out["params"]["embed"].dtype == torch.bfloat16
    whole = launch_train.train_lm(cfg, 4, 2, 32, ckpt_dir=str(tmp_path / "a"),
                                  device="cpu")
    part = launch_train.train_lm(cfg, 2, 2, 32, ckpt_dir=str(tmp_path / "b"),
                                 device="cpu")
    assert part["steps"] == 2
    cont = launch_train.train_lm(cfg, 4, 2, 32, ckpt_dir=str(tmp_path / "b"),
                                 device="cpu")
    assert cont["steps"] == whole["steps"] == 4
    assert cont["final_loss"] == whole["final_loss"]
    from repro_torch.checkpoint.checkpointer import Checkpointer
    ma = Checkpointer(str(tmp_path / "a")).manifest(4)["leaves"]
    mb = Checkpointer(str(tmp_path / "b")).manifest(4)["leaves"]
    assert ma.keys() == mb.keys()
    assert all(ma[k]["crc"] == mb[k]["crc"] for k in ma)
    assert ma["params::embed"]["dtype"] == "bfloat16"
    params = Checkpointer(str(tmp_path / "b")).restore(
        {"params": out["params"], "opt": out["opt_state"]})["params"]
    assert params["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v3-671b"])
def test_train_cli_trains_an_lm_on_cpu(arch, capsys):
    out = launch_train.main(["--arch", arch, "--device", "cpu", "--steps",
                             "3", "--batch", "2", "--seq", "16"])
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["final_loss"])
    assert "params" not in out and "done in" in capsys.readouterr().out
