"""The control: the plain reference put in the program's place and computed
one precision below the configuration's, run through the harness like the
program, so that the harness's own comparison has to read it as not
correct.

The precisions are those of the reference's ``forward``: ``tf32`` (TF32
operands for every float32 matrix product, whose configuration turns TF32
off) and ``int4`` (an int8 tier's pages held to +-7).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def precisions(cfg: dict) -> List[str]:
    """The controls of ``cfg``: one step down for each precision it
    states (float32 products; an int8 tier)."""
    return ["tf32", "int4"] if cfg["storage"] == "int8" else ["tf32"]


class _Binding:
    def __init__(self, reference, cfg, params, tables, precision):
        self.reference, self.cfg = reference, cfg
        self.params, self.tables = params, tables
        self.precision = precision
        self.scales = None          # an int8 tier's page scales, once
        if cfg["storage"] == "int8":
            qmax = reference.QMAX["int4" if precision == "int4" else "int8"]
            self.scales = reference.page_scales(tables, cfg, qmax)

    def execute(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        out = self.reference.forward(self.cfg, self.params, self.tables,
                                     batch, precision=self.precision,
                                     scales=self.scales)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        return out


class Control:
    """A system (``build``, ``reset_counters``, ``counters``) whose binding
    scores each batch with ``reference.forward`` at ``precision``."""

    def __init__(self, reference, precision: str):
        self.reference, self.precision = reference, precision

    def build(self, cfg: dict, params, tables, pool: Sequence[dict],
              row_offsets, device) -> _Binding:
        return _Binding(self.reference, cfg, params, tables, self.precision)

    def reset_counters(self, binding) -> None:
        pass

    def counters(self, binding) -> List[str]:
        return [f"control: the reference at {self.precision}"]
