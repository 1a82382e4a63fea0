"""The port's GNN family (``repro_torch.models.gnn``, the GNN configs,
``data/synth.py``'s graph generators, ``launch.train.train_gnn``) against
``repro.models.gnn`` on the CPU.

The reference runs on ``make_mesh((1, 1))`` under ``jax.jit``; its weights
are drawn with its PRNG and carried across as numpy leaves.

Tolerances.
- Forwards (logits) within 1e-5 relative and 1e-6 absolute: fp32 in both,
  the segment sums and the matmuls reduce in other orders (measured
  ~1e-7).
- One ``adam`` train step: the loss within 1e-6 relative and the
  parameters within 1e-5 absolute (adam's first step moves each weight by
  about lr = 1e-2 times the sign of its gradient, so a gradient at the
  noise level may move either way: such weights are at most 2 lr apart,
  and the test counts them, at most 1 % of a leaf).
- The generators and the sampler: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import synth as jsynth
from repro.distributed.sharding import make_mesh
from repro.models import gnn as jgnn
from repro.models import params as jprm
from repro.optim import optimizers as jopt

from repro_torch.configs import GNN_SHAPES, get_config, reduced, reduced_shape
from repro_torch.data import synth
from repro_torch.launch import train as launch_train
from repro_torch.models import gnn
from repro_torch.optim import optimizers as opt

MESH = make_mesh((1, 1), ("data", "model"))
ARCH = "graphsage-reddit"
N, E, F = 40, 160, 16
FWD_TOL = dict(rtol=1e-5, atol=1e-6)


def _carried(d_feat=F, seed=0):
    jcfg, pcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jp = jprm.initialize(jgnn.model_specs(jcfg, d_feat),
                         jax.random.PRNGKey(seed))
    pp = gnn.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, d_feat,
                               "cpu")
    return jcfg, pcfg, jp, pp


def _graph(rng, n=N, e=E):
    return {"feats": rng.normal(size=(n, F)).astype(np.float32),
            "edges": rng.integers(0, n, (e, 2)).astype(np.int32),
            "labels": rng.integers(0, 5, n).astype(np.int32)}


def _minibatch(rng, n=N, B=8, f1=3, f2=2):
    return {"feats": rng.normal(size=(n, F)).astype(np.float32),
            "roots": rng.integers(0, n, B).astype(np.int32),
            "hop1": rng.integers(0, n, (B, f1)).astype(np.int32),
            "hop2": rng.integers(0, n, (B, f1, f2)).astype(np.int32),
            "labels": rng.integers(0, 5, B).astype(np.int32)}


def _molecules(rng, G=6, n=10, e=20):
    return {"feats": rng.normal(size=(G, n, F)).astype(np.float32),
            "edges": rng.integers(0, n, (G, e, 2)).astype(np.int32),
            "labels": rng.integers(0, 5, G).astype(np.int32)}


def _jforward(regime, jcfg, jp, batch):
    fn = {"full": lambda p, b: jgnn.full_forward(p, b["feats"], b["edges"],
                                                 jcfg, MESH),
          "minibatch": lambda p, b: jgnn.minibatch_forward(
              p, b["feats"], b, jcfg, MESH),
          "molecule": lambda p, b: jgnn.molecule_forward(
              p, b["feats"], b["edges"], jcfg, MESH)}[regime]
    with MESH:
        return np.asarray(jax.jit(fn)(jp, {k: jnp.asarray(v)
                                           for k, v in batch.items()}))


def _pforward(regime, pcfg, pp, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        if regime == "full":
            return gnn.full_forward(pp, t["feats"], t["edges"], pcfg).numpy()
        if regime == "minibatch":
            return gnn.minibatch_forward(pp, t["feats"], t, pcfg).numpy()
        return gnn.molecule_forward(pp, t["feats"], t["edges"],
                                    pcfg).numpy()


BATCHES = {"full": _graph, "minibatch": _minibatch, "molecule": _molecules}


# ------------------------------------------------------------------ configs
def test_gnn_config_shapes_and_registry_equal_the_reference():
    j, p = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert dataclasses.asdict(reduced(p)) == dataclasses.asdict(jreduced(j))
    assert {k: dataclasses.asdict(v) for k, v in GNN_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.GNN_SHAPES.items()}
    for k, s in GNN_SHAPES.items():
        assert dataclasses.asdict(reduced_shape(s)) == dataclasses.asdict(
            jbase.reduced_shape(jbase.GNN_SHAPES[k]))
    assert p.shapes() is GNN_SHAPES
    assert gnn.layer_dims(p, 602) == jgnn.layer_dims(j, 602) == [602, 128, 41]


def test_params_from_numpy_is_strict_and_init_draws_the_specs():
    jcfg, pcfg, jp, pp = _carried()
    for lp, jl in zip(pp["layers"], jp["layers"]):
        for k in jl:
            np.testing.assert_array_equal(lp[k].numpy(), np.asarray(jl[k]))
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(KeyError):
        gnn.params_from_numpy({"layers": tree["layers"][:1]}, pcfg, F, "cpu")
    with pytest.raises(ValueError):
        gnn.params_from_numpy(tree, pcfg, F + 1, "cpu")
    mine = gnn.init_params(pcfg, F, seed=3, device="cpu")
    again = gnn.init_params(pcfg, F, seed=3, device="cpu")
    for a, b, s in zip(mine["layers"], again["layers"],
                       gnn.model_specs(pcfg, F)["layers"]):
        assert {k: tuple(v.shape) for k, v in a.items()} == {
            k: v.shape for k, v in s.items()}
        assert not a["bias"].any()
        for k in a:
            assert torch.equal(a[k], b[k])


# ----------------------------------------------------------------- forwards
@pytest.mark.parametrize("regime", ["full", "minibatch", "molecule"])
def test_forward_equals_the_reference(regime):
    jcfg, pcfg, jp, pp = _carried()
    batch = BATCHES[regime](np.random.default_rng(1))
    want = _jforward(regime, jcfg, jp, batch)
    got = _pforward(regime, pcfg, pp, batch)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_full_graph_out_of_range_edges_and_pad_edges_are_inert():
    """A src outside [0, N) gives no row and no degree, a dst outside is
    dropped, in both packages; pad edges [-1, 0] (the reference's own
    test) change nothing."""
    jcfg, pcfg, jp, pp = _carried()
    rng = np.random.default_rng(2)
    g = _graph(rng)
    g["edges"][:5, 0] = [-1, N, N + 3, -7, 2]
    g["edges"][5:9, 1] = [-1, N, -3, N + 9]
    np.testing.assert_allclose(_pforward("full", pcfg, pp, g),
                               _jforward("full", jcfg, jp, g), **FWD_TOL)
    clean = _graph(np.random.default_rng(3))
    padded = dict(clean, edges=np.concatenate(
        [clean["edges"], np.array([[-1, 0]] * 8, np.int32)]))
    np.testing.assert_array_equal(_pforward("full", pcfg, pp, clean),
                                  _pforward("full", pcfg, pp, padded))


def test_minibatch_out_of_range_ids_gather_zero_rows():
    jcfg, pcfg, jp, pp = _carried()
    mb = _minibatch(np.random.default_rng(4))
    mb["roots"][:2] = [-1, N]
    mb["hop1"][0, :2] = [N + 5, -3]
    mb["hop2"][1, 0, :] = [-1, N]
    np.testing.assert_allclose(_pforward("minibatch", pcfg, pp, mb),
                               _jforward("minibatch", jcfg, jp, mb),
                               **FWD_TOL)
    rows = gnn.sharded_feature_gather(torch.ones(3, 2),
                                      torch.tensor([[0, -1], [3, 2]]))
    assert rows.tolist() == [[1, 1], [0, 0], [0, 0], [1, 1]]


def test_molecule_out_of_range_src_follows_the_reference_take():
    """The reference's ``jnp.take`` wraps a src in [-n, 0) once and fills
    NaN for one outside [-n, n): those graphs' logits are NaN in both; a
    dst outside [0, n) is dropped."""
    jcfg, pcfg, jp, pp = _carried()
    mol = _molecules(np.random.default_rng(5))
    n = mol["feats"].shape[1]
    mol["edges"][1, 0, 0] = -3
    mol["edges"][2, 1, 1] = -1
    mol["edges"][3, 2, 1] = n
    np.testing.assert_allclose(_pforward("molecule", pcfg, pp, mol),
                               _jforward("molecule", jcfg, jp, mol),
                               **FWD_TOL)
    mol["edges"][4, 0, 0] = n + 2
    mol["edges"][5, 0, 0] = -n - 1
    got = _pforward("molecule", pcfg, pp, mol)
    want = _jforward("molecule", jcfg, jp, mol)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[4:]).all() and not np.isnan(got[:4]).any()
    np.testing.assert_allclose(got[:4], want[:4], **FWD_TOL)


def test_chunked_aggregation_equals_one_chunk(monkeypatch):
    """Edges summed in chunks of 7 rows against one chunk: equal within
    fp32 rounding, forward and gradient."""
    rng = np.random.default_rng(6)
    h = torch.from_numpy(rng.normal(size=(30, 4)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, 30, 200))
    dst = torch.from_numpy(rng.integers(0, 30, 200))
    w = torch.from_numpy(rng.normal(size=(30, 4)).astype(np.float32))
    outs = []
    for chunk_bytes in (gnn.AGG_BYTES, 7 * 4 * 4):
        monkeypatch.setattr(gnn, "AGG_BYTES", chunk_bytes)
        x = h.clone().requires_grad_()
        out = gnn.aggregate(x, src, dst, 30)
        (g,) = torch.autograd.grad((out * w).sum(), [x])
        outs.append((out.detach(), g))
    assert gnn._chunk(4) == 7
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    want = torch.zeros(30, 4).index_add_(0, dst, h[src])
    torch.testing.assert_close(outs[1][0], want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- train steps
@pytest.mark.parametrize("regime", ["full", "minibatch", "molecule"])
def test_adam_train_step_equals_the_reference(regime):
    jcfg, pcfg, jp, pp = _carried()
    batch = BATCHES[regime](np.random.default_rng(7))
    jo = jopt.adam(1e-2)
    jstep = jax.jit(jgnn.make_train_step(jcfg, MESH, jo, regime))
    with MESH:
        jp2, _, jm = jstep(jp, jo.init(jp), {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    po = opt.adam(1e-2)
    ps = po.init(pp)
    pp2, ps2, pm = gnn.make_train_step(pcfg, po, regime)(
        pp, ps, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert pp2 is pp and int(ps2["step"]) == 1
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    for lp, jl in zip(pp2["layers"], jp2["layers"]):
        for k in jl:
            got, want = lp[k].numpy(), np.asarray(jl[k])
            far = np.abs(got - want) > 1e-5
            assert far.mean() <= 0.01, (regime, k, far.mean())
            assert np.abs(got - want).max() <= 2.0001e-2


def test_full_step_with_kept_edges_and_loss_falls():
    """``graph_edges`` computed once gives the step's loss as the raw
    edges do; the loss falls over 4 steps on one graph."""
    _, pcfg, _, pp = _carried()
    g = {k: torch.from_numpy(v)
         for k, v in _graph(np.random.default_rng(8)).items()}
    kept = dict(g, graph=gnn.graph_edges(g["edges"], N))
    with torch.no_grad():
        assert torch.equal(gnn.loss_fn(pp, g, pcfg, "full"),
                           gnn.loss_fn(pp, kept, pcfg, "full"))
    po = opt.adam(1e-2)
    ps = po.init(pp)
    step = gnn.make_train_step(pcfg, po, "full")
    losses = [float(step(pp, ps, kept)[2]["loss"]) for _ in range(4)]
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError, match="regime"):
        gnn.loss_fn(pp, kept, pcfg, "other")


# ----------------------------------------------------- generators, sampler
def test_graph_generators_equal_the_reference_bit_for_bit():
    for args in ((256, 2048, 32, 41, 0), (50, 300, 7, 5, 3)):
        a, b = synth.make_graph(*args), jsynth.make_graph(*args)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        for x, y in zip(synth.to_csr(args[0], a["edges"]),
                        jsynth.to_csr(args[0], b["edges"])):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for a, b in zip(synth.molecule_batches(4, 30, 64, 32, 5, 3, seed=2),
                    jsynth.molecule_batches(4, 30, 64, 32, 5, 3, seed=2)):
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_sampler_equals_the_reference_bit_for_bit():
    """Including the self-loop fallback: nodes 0-9 have no out-edge."""
    g = jsynth.make_graph(60, 400, 4, 3, seed=1)
    edges = g["edges"][g["edges"][:, 0] >= 10]
    indptr, indices = synth.to_csr(60, edges)
    assert (np.diff(indptr)[:10] == 0).all()
    ps = gnn.make_sampler(indptr, indices, (4, 3), seed=5)
    js = jgnn.make_sampler(indptr, indices, (4, 3), seed=5)
    roots = np.arange(16) * 3
    for _ in range(3):
        a, b = ps(roots), js(roots)
        for k in ("roots", "hop1", "hop2"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    assert (a["hop1"][:4] == roots[:4, None]).all()   # self-loops


# ------------------------------------------------------------ train_gnn, CLI
def test_train_gnn_and_the_cli_on_cpu(capsys):
    out = launch_train.main(["--arch", ARCH, "--device", "cpu", "--steps",
                             "12"])
    assert np.isfinite(out["first_loss"])
    assert out["final_loss"] < out["first_loss"]
    assert "done in" in capsys.readouterr().out
    full = launch_train.train_gnn(get_config(ARCH), 2, device="cpu")
    assert [tuple(lp["w_self"].shape) for lp in full["params"]["layers"]] \
        == [(32, 128), (128, 41)]
