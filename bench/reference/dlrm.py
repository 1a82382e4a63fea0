"""The plain reference of the DLRM serve step (PIFS-Rec Fig. 1, Table I),
its inputs, and its operation and byte counts.

Plain float32 PyTorch with TF32 off; it imports nothing of the program.

    x      = relu(... relu(dense @ W0 + b0) ... @ Wn + bn)    bottom MLP
    x      = x @ P               when the bottom MLP does not end at D
    f_t    = sum_l w[t, l] * row(ids[t, l])                   l = 0..L-1
    inter  = lower triangle (i > j) of F F^T, F = [x, f_0 .. f_{T-1}]
    score  = sigmoid(top MLP([x, inter]))                     ReLU between

Tables are logical: one (T * rows, D) float32 matrix, table t at rows
``row_offsets(cfg)[t]``.  A configuration whose cold tier is stored as int8
(``storage: "int8"``) is held to every row quantized per page: a page is
``page_bytes`` of stored codes, its scale max|x| / 127 (1 for an all-zero
page), codes round half to even and clip to +-127.  The reference does
this itself from the logical tables and knows nothing of which pages the
program keeps in float32 in its hot tier.

``precision`` selects the control's lower precisions: ``"tf32"`` rounds
every matrix product's operands to TF32 (10 mantissa bits, to nearest
even) and accumulates in float32, as the tensor cores do; ``"int4"``
quantizes the int8 tier's pages to +-7 instead of +-127.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

TABLE_STD = 0.01      # tables ~ N(0, 0.01^2), the port's own init scale
BIAS_STD = 0.01       # biases ~ N(0, 0.01^2); weights ~ N(0, 1 / fan_in)
QMAX = {"int8": 127, "int4": 7}


# ------------------------------------------------------------------ sizes
def cold_itemsize(cfg: dict) -> int:
    return 1 if cfg["storage"] == "int8" else 4


def page_rows(cfg: dict) -> int:
    """Rows in one page of ``page_bytes`` stored bytes."""
    return max(1, cfg["page_bytes"] // (cfg["emb_dim"] * cold_itemsize(cfg)))


def row_offsets(cfg: dict) -> np.ndarray:
    """First logical row of each table: tables start on a page."""
    ps = page_rows(cfg)
    per = -(-cfg["emb_num"] // ps) * ps
    return np.arange(cfg["n_tables"], dtype=np.int64) * per


def n_pairs(cfg: dict) -> int:
    f = cfg["n_tables"] + 1
    return f * (f - 1) // 2


def _layers(cfg: dict):
    """(name, fan_in, fan_out) of every weight matrix, in draw order."""
    d = cfg["emb_dim"]
    bottom = [cfg["n_dense"]] + list(cfg["bottom_mlp"])
    top = [n_pairs(cfg) + d] + list(cfg["top_mlp"])
    out = [(f"bottom.layer{i}", a, b)
           for i, (a, b) in enumerate(zip(bottom[:-1], bottom[1:]))]
    out += [(f"top.layer{i}", a, b)
            for i, (a, b) in enumerate(zip(top[:-1], top[1:]))]
    if cfg["bottom_mlp"][-1] != d:
        out.append(("bot_proj", cfg["bottom_mlp"][-1], d))
    return out


def flops_per_item(cfg: dict) -> int:
    """Operations one item needs: two per multiply-add of every matrix
    product (MLPs and projection), the interaction's P dots of length D,
    and the pooling's T * L weighted adds of D (one more per element to
    dequantize an int8 row)."""
    macs = sum(a * b for _, a, b in _layers(cfg))
    T, L, D = cfg["n_tables"], cfg["pooling"], cfg["emb_dim"]
    pool = T * L * D * (2 + (cfg["storage"] == "int8"))
    return 2 * macs + 2 * n_pairs(cfg) * D + pool


def front_end_cost(cfg: dict, indices: torch.Tensor) -> Tuple[int, int]:
    """(bytes, operations) the front end needs for one batch of global row
    ids (items, T, L): each distinct logical row read once at the cold
    tier's stored width (int8: and each distinct page's 4-byte scale once,
    tables starting on a page), every id and
    weight once, the bottom MLP's (items, D) feature in and the (items, P)
    interaction out; the pooling's multiply-adds (int8: and dequantizing)
    and the interaction's dots.  Independent of the program's placement."""
    B = indices.shape[0]
    N = indices.numel()
    D = cfg["emb_dim"]
    P = n_pairs(cfg)
    uniq = int(torch.unique(indices).numel())
    q = cfg["storage"] == "int8"
    pages = int(torch.unique(indices // page_rows(cfg)).numel()) if q else 0
    nbytes = (uniq * D * cold_itemsize(cfg) + pages * 4 + N * (4 + 4)
              + B * D * 4 + B * P * 4)
    flops = N * D * (2 + q) + B * P * D * 2
    return nbytes, flops


# ----------------------------------------------------------------- inputs
def make_inputs(cfg: dict, seed: int, device
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(params, tables) drawn on ``device`` from ``seed``: the MLPs' weights
    keyed as the port's ``DLRM`` state dict, (in, out) each, and the
    logical float32 tables.  The same seed and device give the same
    values, so the program and the reference each get them afresh."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    rows = int(row_offsets(cfg)[-1]) + -(-cfg["emb_num"]
                                        // page_rows(cfg)) * page_rows(cfg)
    tables = torch.randn((rows, cfg["emb_dim"]), generator=g,
                         device=device).mul_(TABLE_STD)
    params = {}
    for name, a, b in _layers(cfg):
        w = torch.randn((a, b), generator=g, device=device).mul_(
            1.0 / math.sqrt(a))
        if name == "bot_proj":
            params[name] = w
            continue
        params[name + "_w"] = w
        params[name + "_b"] = torch.randn((b,), generator=g,
                                          device=device).mul_(BIAS_STD)
    return params, tables


# -------------------------------------------------------------- reference
def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= (1 << 31), bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def page_scales(tables: torch.Tensor, cfg: dict, qmax: int
                ) -> torch.Tensor:
    """Per-page scale max|x| / qmax (1 for an all-zero page)."""
    ps = page_rows(cfg)
    amax = tables.view(-1, ps, tables.shape[1]).abs().amax(dim=(1, 2))
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def _tier(cfg: dict, precision: str) -> Optional[int]:
    """The quantization range the tables are held to, or None (float32)."""
    if cfg["storage"] != "int8":
        return None
    return QMAX["int4" if precision == "int4" else "int8"]


@torch.no_grad()
def forward(cfg: dict, params: Dict[str, torch.Tensor],
            tables: torch.Tensor, batch: Dict[str, np.ndarray],
            precision: str = "fp32", block: int = 4096,
            scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scores (items,) of one host batch, on the tables' device, computed
    ``block`` items at a time.  ``scales``: the per-page scales of an int8
    tier, computed here when not given."""
    dev = tables.device
    qmax = _tier(cfg, precision)
    if qmax is not None and scales is None:
        scales = page_scales(tables, cfg, qmax)
    ps = page_rows(cfg)
    n_bottom = len(cfg["bottom_mlp"])
    n_top = len(cfg["top_mlp"])
    F = cfg["n_tables"] + 1
    ii, jj = torch.tril_indices(F, F, offset=-1, device=dev)
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
        if "bot_proj" in params:
            x = _mm(x, params["bot_proj"], precision)
        acc = torch.zeros((ids.shape[0], ids.shape[1], cfg["emb_dim"]),
                          device=dev)
        for l in range(ids.shape[2]):
            rows = tables[ids[:, :, l]]
            if qmax is not None:
                sc = scales[ids[:, :, l] // ps][..., None]
                rows = torch.clamp(torch.round(rows / sc), -qmax, qmax) * sc
            acc = acc + w[:, :, l, None] * rows
        feats = torch.cat([x[:, None, :], acc], dim=1)
        if precision == "tf32":
            feats = round_tf32(feats)
        z = torch.bmm(feats, feats.transpose(1, 2))[:, ii, jj]
        h = torch.cat([x, z], dim=-1)
        for i in range(n_top):
            h = _mm(h, params[f"top.layer{i}_w"], precision) \
                + params[f"top.layer{i}_b"]
            if i < n_top - 1:
                h = torch.relu(h)
        out.append(torch.sigmoid(h[:, 0]))
    return torch.cat(out)
