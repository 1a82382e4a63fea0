"""The plain reference of MLPerf's DLRM-DCNv2 serve step (mlcommons/inference
``recommendation/dlrm_v2``, torchrec's ``DLRM_DCN``; the low-rank cross of
DCN-V2, arXiv:2008.13535 section 3), its inputs, and its operation and
byte counts.

Plain float32 PyTorch with TF32 off; it imports nothing of the program.

    x      = relu(... relu(dense @ W0 + b0) ... @ Wn + bn)    bottom MLP
    f_t    = sum_l w[c] * row(ids[c]),  c = c_t .. c_{t+1}-1  each table's
                                                              bag, in order
    x0     = [x, f_0 .. f_{T-1}]                              (B, (T+1) D)
    x_l+1  = x0 * ((x_l @ V_l) @ W_l + b_l) + x_l             3 cross layers
    score  = sigmoid(top MLP(x_3))                            ReLU between

A batch's ``indices`` are (items, sum L_t), table t's bag in the columns
``[c_t, c_{t+1})`` of ``loadgen.bag_edges``.

Tables.  The logical tables are one (rows, D) matrix, table t at rows
``row_offsets(cfg)[t]``, held as the program's int8 tier holds them: int8
codes with one float32 scale per page of ``page_bytes`` codes, a row's
values ``code * scale``.  Every page holds a code of +-127, so quantizing
its values per page (scale max|x| / 127, round half to even) gives back
the same codes and scale: the program's int8 cold tier and its dequantized
float32 hot tier hold exactly the reference's numbers, and no float32 copy
of the tables (104.5 GB at the published sizes) is ever built.

``precision`` selects the control's lower precisions: ``"tf32"`` rounds
every matrix product's operands to TF32 (10 mantissa bits, to nearest
even) and accumulates in float32, as the tensor cores do; ``"int4"``
quantizes each page's values to +-7 instead of +-127.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bench import loadgen
from bench.reference.dlrm import (  # noqa: F401  (QMAX: the control's)
    BIAS_STD, QMAX, TABLE_STD, _mm)

CODE_STD = 127 / 4    # codes ~ N(0, CODE_STD^2), rounded, clipped to +-127
SCALE = 4 * TABLE_STD / 127  # page scales in SCALE * [0.5, 1.5): values
#                              ~ N(0, TABLE_STD^2), as the DLRM tables
DRAW_ROWS = 1 << 21   # table rows drawn at a time


# ------------------------------------------------------------------ sizes
def page_rows(cfg: dict) -> int:
    """Rows in one page of ``page_bytes`` int8 codes."""
    return max(1, cfg["page_bytes"] // cfg["emb_dim"])


def row_offsets(cfg: dict) -> np.ndarray:
    """First logical row of each table: tables start on a page."""
    ps = page_rows(cfg)
    rows = np.asarray(loadgen.tables(cfg)[0], dtype=np.int64)
    padded = -(-rows // ps) * ps
    return np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)


def n_rows(cfg: dict) -> int:
    """Logical rows, every table padded to whole pages."""
    ps = page_rows(cfg)
    return int(sum(-(-r // ps) * ps for r in loadgen.tables(cfg)[0]))


def _layers(cfg: dict):
    """(name, shape) of every parameter, in draw order."""
    d, T = cfg["emb_dim"], len(loadgen.tables(cfg)[0])
    width = (T + 1) * d
    out = []
    bottom = [cfg["n_dense"]] + list(cfg["bottom_mlp"])
    for i, (a, b) in enumerate(zip(bottom[:-1], bottom[1:])):
        out += [(f"bottom.layer{i}_w", (a, b)), (f"bottom.layer{i}_b", (b,))]
    for i in range(cfg["cross_layers"]):
        r = cfg["cross_rank"]
        out += [(f"cross.layer{i}_v", (width, r)),
                (f"cross.layer{i}_w", (r, width)),
                (f"cross.layer{i}_b", (width,))]
    top = [width] + list(cfg["top_mlp"])
    for i, (a, b) in enumerate(zip(top[:-1], top[1:])):
        out += [(f"top.layer{i}_w", (a, b)), (f"top.layer{i}_b", (b,))]
    return out


def flops_per_item(cfg: dict) -> int:
    """Operations one item needs: two per multiply-add of every matrix
    product (MLPs and the cross layers' V and W), three per element of
    each cross layer's bias add, product with x0 and residual add, and the
    pooling's weighted adds of D for every id, one more per element to
    dequantize its int8 row."""
    macs = sum(s[0] * s[1] for _, s in _layers(cfg) if len(s) == 2)
    width = (len(loadgen.tables(cfg)[0]) + 1) * cfg["emb_dim"]
    ids = int(loadgen.bag_edges(cfg)[-1])
    return (2 * macs + 3 * width * cfg["cross_layers"]
            + ids * cfg["emb_dim"] * 3)


def front_end_cost(cfg: dict, indices: torch.Tensor) -> Tuple[int, int]:
    """(bytes, operations) the pooling needs for one batch of global row
    ids (items, sum L_t): each distinct logical row read once as int8
    codes and each distinct page's 4-byte scale once, every id and weight
    once, and the (items, T, D) float32 pooled output written once; three
    operations per id and element (dequantize, multiply, add).
    Independent of the program's placement."""
    B, N = indices.shape[0], indices.numel()
    D = cfg["emb_dim"]
    T = len(loadgen.tables(cfg)[0])
    uniq = int(torch.unique(indices).numel())
    pages = int(torch.unique(indices // page_rows(cfg)).numel())
    nbytes = uniq * D + pages * 4 + N * (4 + 4) + B * T * D * 4
    return nbytes, N * D * 3


# ----------------------------------------------------------------- inputs
def make_inputs(cfg: dict, seed: int, device
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, tables) drawn on ``device`` from ``seed``: the weights
    keyed as the port's ``DLRM`` state dict, (in, out) each, weights ~
    N(0, 1 / fan_in) and biases ~ N(0, BIAS_STD^2), and the
    tables as ``{"codes": (rows, D) int8, "scales": (pages,) float32}``,
    drawn ``DRAW_ROWS`` rows at a time, every page given one code of +-127.
    The same seed and device give the same values, so the program and the
    reference each get them afresh."""
    if cfg["storage"] != "int8":
        raise ValueError("DLRM-DCNv2's tables are held as int8 codes with "
                         "page scales (storage 'int8')")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    rows, D, ps = n_rows(cfg), cfg["emb_dim"], page_rows(cfg)
    codes = torch.empty((rows, D), dtype=torch.int8, device=device)
    step = DRAW_ROWS // ps * ps
    for r0 in range(0, rows, step):
        r1 = min(r0 + step, rows)
        x = torch.randn((r1 - r0, D), generator=g, device=device)
        block = x.mul_(CODE_STD).round_().clamp_(-127, 127)
        pages = block.view(-1, ps * D)
        at = torch.randint(0, ps * D, (pages.shape[0], 1), generator=g,
                           device=device)
        sign = torch.randint(0, 2, (pages.shape[0], 1), generator=g,
                             device=device).mul_(254).sub_(127)
        pages.scatter_(1, at, sign.to(pages.dtype))
        codes[r0:r1] = block.to(torch.int8)
        del x, block, pages
    scales = torch.rand((rows // ps,), generator=g, device=device).add_(
        0.5).mul_(SCALE)
    params = {}
    for name, shape in _layers(cfg):
        x = torch.randn(shape, generator=g, device=device)
        params[name] = (x.mul_(BIAS_STD) if len(shape) == 1
                        else x.mul_(1.0 / math.sqrt(shape[0])))
    return params, {"codes": codes, "scales": scales}


# -------------------------------------------------------------- reference
def page_scales(tables: Dict[str, torch.Tensor], cfg: dict, qmax: int
                ) -> torch.Tensor:
    """Per-page scale max|x| / qmax of the values ``code * scale``: each
    page's largest |code| is 127, so max|x| is 127 * its scale (and at
    ``qmax`` 127 the scale itself)."""
    s = tables["scales"]
    return s if qmax == QMAX["int8"] else (s * 127) / qmax


@torch.no_grad()
def forward(cfg: dict, params: Dict[str, torch.Tensor],
            tables: Dict[str, torch.Tensor], batch: Dict[str, np.ndarray],
            precision: str = "fp32", block: int = 2048,
            scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scores (items,) of one host batch, on the tables' device, computed
    ``block`` items at a time.  ``scales``: the pages' scales at the
    precision's range (:func:`page_scales`), computed here when not
    given."""
    codes, own = tables["codes"], tables["scales"]
    dev = codes.device
    qmax = QMAX["int4" if precision == "int4" else "int8"]
    if scales is None:
        scales = page_scales(tables, cfg, qmax)
    ps = page_rows(cfg)
    edges = loadgen.bag_edges(cfg).tolist()
    n_bottom, n_top = len(cfg["bottom_mlp"]), len(cfg["top_mlp"])
    out = []
    items = batch["dense"].shape[0]
    for s in range(0, items, block):
        dense = torch.as_tensor(batch["dense"][s:s + block], device=dev)
        ids = torch.as_tensor(batch["indices"][s:s + block],
                              device=dev).long()
        w = torch.as_tensor(batch["weights"][s:s + block], device=dev)
        x = dense
        for i in range(n_bottom):
            x = torch.relu(_mm(x, params[f"bottom.layer{i}_w"], precision)
                           + params[f"bottom.layer{i}_b"])
        page = ids // ps
        rows = codes[ids].to(torch.float32)
        if precision == "int4":
            sc = scales[page][..., None]
            rows = torch.clamp(torch.round(rows * own[page][..., None] / sc),
                               -qmax, qmax) * sc
        else:
            rows = rows * scales[page][..., None]
        feats = [x]
        for a, b in zip(edges[:-1], edges[1:]):
            acc = torch.zeros_like(x)
            for c in range(a, b):
                acc = acc + w[:, c, None] * rows[:, c]
            feats.append(acc)
        x0 = torch.cat(feats, dim=-1)
        h = x0
        for i in range(cfg["cross_layers"]):
            z = _mm(_mm(h, params[f"cross.layer{i}_v"], precision),
                    params[f"cross.layer{i}_w"], precision)
            h = x0 * (z + params[f"cross.layer{i}_b"]) + h
        for i in range(n_top):
            h = _mm(h, params[f"top.layer{i}_w"], precision) \
                + params[f"top.layer{i}_b"]
            if i < n_top - 1:
                h = torch.relu(h)
        out.append(torch.sigmoid(h[:, 0]))
    return torch.cat(out)
