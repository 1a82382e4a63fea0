"""GraphSAGE (mean aggregator) in three execution regimes, the port of
``repro.models.gnn`` on one card.

Message passing is gather by ``src``, sum by ``dst``, divide by the
degree.  The reference shards the features over ``model`` and the edges
over ``data`` and sums the partials with ``psum`` / ``psum_scatter``; on
its (1, 1) mesh that is one segment sum, computed here as
:func:`aggregate`: the edges in chunks of at most ``AGG_BYTES`` of
gathered rows, each chunk's ``h[src]`` summed into ``dst`` with
``index_add_`` (ogbn-products' 61,859,140 edges gather 24.7 GB of rows at
d = 100 in one piece).  Its backward walks the same chunks, so a step
holds one chunk of rows at a time.  The order of the fp32 sums is
``index_add_``'s, which the reference's ``segment_sum`` does not fix
either.

Edge semantics, held to the reference's by the tests:

* full graph: a ``src`` outside ``[0, N)`` contributes a zero row and no
  degree (the reference's ``owned`` mask); a ``dst`` outside ``[0, N)``
  is dropped (``segment_sum``);
* molecules: ``jnp.take(h, src)`` wraps a ``src`` in ``[-n, 0)`` once and
  gives a NaN row for one outside ``[-n, n)``; every edge with a ``dst``
  in ``[0, n)`` counts in the degree, whatever its ``src``;
* minibatch: a feature id outside ``[0, N)`` gathers a zero row.

Regimes: ``full`` (Cora / ogbn-products shapes), ``minibatch`` (Reddit:
a host-side CSR sampler, :func:`make_sampler`, emits fixed-shape (B, f1),
(B, f1, f2) id tensors) and ``molecule`` (a batch of small graphs: one
segment sum over the batch with per-graph node offsets, where the
reference maps over the graphs).  A dry-run's fake edges keep every edge
(exact for ids in range); :func:`input_specs` gives its stand-in batches
(``input_pspecs`` has nothing to shard on one card).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike, is_fake, resolve_device
from repro_torch.models.params import Spec, initialize_specs

# gathered rows per aggregation chunk, in bytes
AGG_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def layer_dims(cfg: GNNConfig, d_feat: int) -> list:
    return [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]


def model_specs(cfg: GNNConfig, d_feat: int, dtype=torch.float32) -> dict:
    dims = layer_dims(cfg, d_feat)
    return {"layers": [{"w_self": Spec((a, b), dtype),
                        "w_neigh": Spec((a, b), dtype),
                        "bias": Spec((b,), dtype, init="zeros")}
                       for a, b in zip(dims[:-1], dims[1:])]}


def init_params(cfg: GNNConfig, d_feat: int, seed: int = 0,
                device: DeviceLike = None) -> dict:
    """Random weights by the specs, drawn from ``seed`` on the device."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return {"layers": [initialize_specs(lp, gen)
                       for lp in model_specs(cfg, d_feat)["layers"]]}


def params_from_numpy(tree, cfg: GNNConfig, d_feat: int,
                      device: DeviceLike = None) -> dict:
    """The reference's tree (``{"layers": [{w_self, w_neigh, bias}, ...]}``
    of numpy leaves) -> the port's; strict on keys and shapes."""
    dev = resolve_device(device)
    specs = model_specs(cfg, d_feat)["layers"]
    if set(tree) != {"layers"} or len(tree["layers"]) != len(specs):
        raise KeyError(f"want {{'layers': [{len(specs)} layers]}}")
    out: List[Dict[str, torch.Tensor]] = []
    for i, (lp, ls) in enumerate(zip(tree["layers"], specs)):
        if set(lp) != set(ls):
            raise KeyError(f"layer {i}: keys {sorted(lp)} != {sorted(ls)}")
        layer = {}
        for k, s in ls.items():
            a = np.asarray(lp[k])
            if tuple(a.shape) != s.shape:
                raise ValueError(f"layers.{i}.{k}: shape {a.shape} != "
                                 f"{s.shape}")
            layer[k] = torch.from_numpy(np.array(a, order="C")).to(
                device=dev, dtype=s.dtype)
        out.append(layer)
    return {"layers": out}


def _sage_combine(lp: dict, h_self: torch.Tensor, h_neigh: torch.Tensor,
                  last: bool) -> torch.Tensor:
    out = h_self @ lp["w_self"] + h_neigh @ lp["w_neigh"] + lp["bias"]
    if not last:
        out = torch.relu(out)
        # GraphSAGE l2-normalizes hidden layers
        out = out / torch.linalg.vector_norm(
            out, dim=-1, keepdim=True).clamp_min(1e-6)
    return out


# ---------------------------------------------------------------------------
# Aggregation: gather by src, sum into dst, in edge chunks
# ---------------------------------------------------------------------------


def _chunk(d: int) -> int:
    return max(1, AGG_BYTES // (4 * max(d, 1)))


def _gather_sum(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                n_out: int, chunk: int) -> torch.Tensor:
    """``out[dst[e]] += h[src[e]]`` over (n_out, d) zeros, ``chunk`` edges
    at a time."""
    out = h.new_zeros((n_out, h.shape[1]))
    for e0 in range(0, src.numel(), chunk):
        out.index_add_(0, dst[e0:e0 + chunk],
                       h.index_select(0, src[e0:e0 + chunk]))
    return out


class _GatherSum(torch.autograd.Function):
    """:func:`_gather_sum` whose backward is the same walk with ``src``
    and ``dst`` swapped: the output's gradient gathered by ``dst`` and
    summed into ``src``."""

    @staticmethod
    def forward(ctx, h, src, dst, n_out, chunk):
        ctx.save_for_backward(src, dst)
        ctx.n_in, ctx.chunk = h.shape[0], chunk
        return _gather_sum(h, src, dst, n_out, chunk)

    @staticmethod
    def backward(ctx, dout):
        src, dst = ctx.saved_tensors
        return (_gather_sum(dout, dst, src, ctx.n_in, ctx.chunk),
                None, None, None, None)


def aggregate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              n_out: int) -> torch.Tensor:
    """The (n_out, d) sums of ``h[src]`` by ``dst``; every id in range
    (the callers filter), int64."""
    return _GatherSum.apply(h, src, dst, n_out, _chunk(h.shape[1]))


def graph_edges(edges, n_nodes: int) -> Dict[str, Any]:
    """The full-graph regime's kept edges, int64 on the edges' device: an
    edge whose ``src`` or ``dst`` is outside ``[0, N)`` goes
    (no row, no degree), and the degree of each node counts the rest."""
    e = torch.as_tensor(edges)
    src, dst = e[:, 0].long(), e[:, 1].long()
    if not is_fake(e):     # a dry-run keeps every edge: exact in range
        keep = (src >= 0) & (src < n_nodes) & (dst >= 0) & (dst < n_nodes)
        src, dst = src[keep], dst[keep]
    return {"src": src, "dst": dst,
            "deg": _degrees(dst, n_nodes, torch.float32)}


def _degrees(dst: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """In-degrees of ``n`` nodes (a dry-run's fake ids: the shape only)."""
    if is_fake(dst):
        return dst.new_zeros(n, dtype=dtype)
    return torch.bincount(dst, minlength=n).to(dtype)


# ---------------------------------------------------------------------------
# Full-graph regime
# ---------------------------------------------------------------------------


def full_forward(params: dict, feats: torch.Tensor, edges, cfg: GNNConfig,
                 graph: Dict[str, Any] = None) -> torch.Tensor:
    """feats (N, F), edges (E, 2) [src, dst] -> logits (N, n_classes).
    ``graph`` is :func:`graph_edges` of ``edges`` when the caller keeps
    it across steps."""
    N = feats.shape[0]
    g = graph if graph is not None else graph_edges(
        torch.as_tensor(edges, device=feats.device), N)
    norm = g["deg"].clamp_min(1.0)[:, None]
    h = feats
    for i, lp in enumerate(params["layers"]):
        neigh = aggregate(h, g["src"], g["dst"], N) / norm
        h = _sage_combine(lp, h, neigh, last=i == cfg.n_layers - 1)
    return h


# ---------------------------------------------------------------------------
# Minibatch regime (fanout-sampled blocks)
# ---------------------------------------------------------------------------


def sharded_feature_gather(feats: torch.Tensor, ids) -> torch.Tensor:
    """Rows of ``feats`` for the flat ``ids``; an id outside ``[0, N)``
    gives a zero row (the reference's masked partial gather on one
    shard)."""
    ids = torch.as_tensor(ids, device=feats.device).reshape(-1).long()
    N = feats.shape[0]
    owned = (ids >= 0) & (ids < N)
    rows = feats.index_select(0, ids.clamp(0, N - 1))
    return rows * owned.to(rows.dtype)[:, None]


def minibatch_forward(params: dict, feats: torch.Tensor,
                      batch: Dict[str, Any], cfg: GNNConfig) -> torch.Tensor:
    """2-hop fanout-sampled forward.  batch: roots (B,), hop1 (B, f1), hop2
    (B, f1, f2) node ids."""
    B, f1 = batch["hop1"].shape
    f2 = batch["hop2"].shape[2]
    d = feats.shape[1]
    x_root = sharded_feature_gather(feats, batch["roots"])
    x_h1 = sharded_feature_gather(feats, batch["hop1"]).reshape(B, f1, d)
    x_h2 = sharded_feature_gather(feats, batch["hop2"]).reshape(B, f1, f2,
                                                                 d)
    # layer 1: hop1 nodes aggregate their hop2 neighbours
    lp = params["layers"][0]
    h1 = _sage_combine(lp, x_h1, x_h2.mean(2), last=False)   # (B, f1, d')
    r1 = _sage_combine(lp, x_root, x_h1.mean(1), last=False)  # (B, d')
    # layer 2: roots aggregate their (now-updated) hop1 neighbours
    return _sage_combine(params["layers"][1], r1, h1.mean(1), last=True)


def make_sampler(indptr: np.ndarray, indices: np.ndarray,
                 fanout: Tuple[int, int], seed: int = 0):
    """Host-side uniform neighbor sampler over CSR (with replacement;
    isolated nodes sample themselves -- self-loop fallback)."""
    rng = np.random.default_rng(seed)

    def sample_one_hop(ids: np.ndarray, k: int) -> np.ndarray:
        flat = ids.reshape(-1)
        deg = indptr[flat + 1] - indptr[flat]
        pick = rng.integers(0, np.maximum(deg, 1)[:, None],
                            size=(flat.size, k))
        starts = indptr[flat]
        # clip for deg-0 nodes (value replaced by the self-loop below)
        pos = np.minimum(starts[:, None] + pick, len(indices) - 1)
        nbr = indices[pos]
        nbr = np.where(deg[:, None] > 0, nbr, flat[:, None])   # self-loop
        return nbr.reshape(ids.shape + (k,))

    def sample(roots: np.ndarray):
        hop1 = sample_one_hop(roots, fanout[0])                # (B, f1)
        hop2 = sample_one_hop(hop1, fanout[1])                 # (B, f1, f2)
        return {"roots": roots.astype(np.int32),
                "hop1": hop1.astype(np.int32),
                "hop2": hop2.astype(np.int32)}

    return sample


# ---------------------------------------------------------------------------
# Batched-small-graphs regime (molecules)
# ---------------------------------------------------------------------------


def molecule_forward(params: dict, feats: torch.Tensor, edges,
                     cfg: GNNConfig) -> torch.Tensor:
    """feats (G, n, F), edges (G, E, 2) -> per-graph logits (G,
    n_classes) by a mean readout.  The G graphs are one graph of G * n
    nodes: graph g's node j is node g * n + j."""
    G, n, _ = feats.shape
    e = torch.as_tensor(edges, device=feats.device).long()
    off = (torch.arange(G, device=feats.device) * n)[:, None]
    src = torch.where(e[..., 0] < 0, e[..., 0] + n, e[..., 0])
    bad = ((src < 0) | (src >= n)).reshape(-1)
    src = (src.clamp(0, n - 1) + off).reshape(-1)
    keep = ((e[..., 1] >= 0) & (e[..., 1] < n)).reshape(-1)
    dst = (e[..., 1] + off).reshape(-1)
    fake = is_fake(e)              # a dry-run keeps every edge, no NaN row
    if not fake:
        dst = dst[keep]
    deg = _degrees(dst, G * n, feats.dtype)
    norm = deg.clamp_min(1.0)[:, None]
    src_k = src if fake else src[keep]
    # the reference's take fills a NaN row for a bad src: its dst sums to
    # NaN
    nan_dst = None
    if not fake and bool(bad.any()):
        nan_dst = torch.zeros(G * n, dtype=torch.bool, device=feats.device)
        nan_dst[dst[bad[keep]]] = True
    h = feats.reshape(G * n, -1)
    for i, lp in enumerate(params["layers"]):
        agg = aggregate(h, src_k, dst, G * n)
        if nan_dst is not None:
            agg = torch.where(nan_dst[:, None], float("nan"), agg)
        h = _sage_combine(lp, h, agg / norm, last=i == cfg.n_layers - 1)
    return h.reshape(G, n, -1).mean(1)


# ---------------------------------------------------------------------------
# Losses / steps
# ---------------------------------------------------------------------------


def input_specs(cfg: GNNConfig, shape, pad_nodes: Optional[int] = None,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A dry-run's batch per GNN shape descriptor: empty tensors with the
    reference's keys, shapes and dtypes (``pad_nodes`` replaces the node
    count of the full and minibatch graphs), fake under the caller's
    ``FakeTensorMode``."""
    dev = resolve_device(device)

    def empty(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device=dev)
    f32 = torch.float32
    if shape.kind == "full":
        N = pad_nodes or shape.n_nodes
        return {"feats": empty((N, shape.d_feat), f32),
                "edges": empty((shape.n_edges, 2)),
                "labels": empty((N,))}
    if shape.kind == "minibatch":
        N = pad_nodes or shape.n_nodes
        B = shape.batch_nodes
        f1, f2 = shape.fanout
        return {"feats": empty((N, shape.d_feat), f32),
                "roots": empty((B,)), "hop1": empty((B, f1)),
                "hop2": empty((B, f1, f2)), "labels": empty((B,))}
    G = shape.graph_batch
    return {"feats": empty((G, shape.n_nodes, shape.d_feat), f32),
            "edges": empty((G, shape.n_edges, 2)),
            "labels": empty((G,))}


def _xent(logits: torch.Tensor, labels) -> torch.Tensor:
    lg = torch.log_softmax(logits.float(), dim=-1)
    labels = torch.as_tensor(labels, device=lg.device).long()
    return -lg.gather(-1, labels[..., None])[..., 0].mean()


def loss_fn(params: dict, batch: Dict[str, Any], cfg: GNNConfig,
            regime: str) -> torch.Tensor:
    if regime == "full":
        logits = full_forward(params, batch["feats"], batch["edges"], cfg,
                              graph=batch.get("graph"))
    elif regime == "minibatch":
        logits = minibatch_forward(params, batch["feats"], batch, cfg)
    elif regime == "molecule":
        logits = molecule_forward(params, batch["feats"], batch["edges"],
                                  cfg)
    else:
        raise ValueError(f"regime {regime!r}")
    return _xent(logits, batch["labels"])


def _leaves(params: dict) -> List[torch.Tensor]:
    return [t for lp in params["layers"] for t in lp.values()]


def make_train_step(cfg: GNNConfig, optimizer, regime: str):
    """``(params, opt_state, batch) -> (params, opt_state, {"loss"})``,
    parameters and optimizer state updated in place.  A full-graph batch
    may carry ``"graph"`` (:func:`graph_edges` of its edges), computed
    once for every step."""
    def step(params, opt_state, batch):
        leaves = _leaves(params)
        alias = [p.detach().requires_grad_() for p in leaves]
        it = iter(alias)
        tree = {"layers": [{k: next(it) for k in lp}
                           for lp in params["layers"]]}
        loss = loss_fn(tree, batch, cfg, regime)
        grads = iter(torch.autograd.grad(loss, alias))
        optimizer.update({"layers": [{k: next(grads) for k in lp}
                                     for lp in params["layers"]]},
                         opt_state, params)
        return params, opt_state, {"loss": loss.detach()}
    return step
