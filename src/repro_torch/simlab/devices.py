"""Hardware parameters for the latency simulator (paper Table II + III).

A copy of ``repro.simlab.devices`` (frozen dataclasses, no JAX), so
the port's simulator prices the same hardware.

The paper evaluates with Ramulator 2.0 wrapped in a 1 ns/clk top module; we
reproduce the same *resource model* analytically: every component is a
(bandwidth, latency) pair and the simulator composes them per system.  Values
below are Table II where given, public datasheet figures otherwise.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareParams:
    # ---- local DRAM (DDR5-4800, 12 channels populated on the socket) ----
    bw_local_GBs: float = 307.0          # 12ch x 4800MT/s x 8B x ~0.67 eff
    lat_local_ns: float = 90.0

    # ---- CXL memory devices (DDR4 behind the switch, Table II) ----
    n_devices: int = 4
    bw_device_GBs: float = 64.0          # downstream port: 64 GB/s x16
    bw_media_GBs: float = 35.0           # DDR4 media behind the port (4ch eff)
    lat_cxl_extra_ns: float = 100.0      # CXL access penalty over DRAM [28]
    lat_switch_ns: float = 25.0          # switch traversal (port+retimer leg)
    lat_proto_ns: float = 135.0          # CXL.mem protocol + retimer legs
    switch_congestion: float = 1.25      # per-extra-port round-trip inflation

    # ---- host link (flex bus upstream, PCIe5 x16) ----
    bw_upstream_GBs: float = 64.0
    outstanding: int = 136               # host line-fetch MSHR/LFB depth
    lat_queue_ns: float = 400.0          # hot-port queueing per unit imbalance

    # ---- host LLC (dual Genoa: large L3 absorbs hot rows for host-centric
    # systems — this is why Pond+PM barely beats Pond in the paper) ----
    host_cache_mb: int = 256

    # ---- on-switch SRAM buffer (Table II: 0.91-4.19 ns per line R/W) ----
    bw_sram_GBs: float = 128.0
    lat_sram_ns: float = 2.5
    buffer_kb_default: int = 512         # paper's sweet spot

    # ---- process core (1 GHz synthesis clock, §VI-D) ----
    pc_GBs: float = 168.0                # accumulate datapath width x 1 GHz
    ooo_stall_free_frac: float = 0.068   # stalls removed by OoO (<=7.3%, Fig12e)

    # ---- host-side reduce (Pond-style communicate-then-reduce) ----
    host_reduce_ns_per_row: float = 1.0

    # ---- BEACON extra memory-translation logic in the switch (§II-B2):
    # translation serializes ahead of the device issue path ----
    beacon_translate_factor: float = 1.05

    # ---- RecNMP: DIMM-side PNM with rank/bank-level parallelism ----
    bw_recnmp_GBs: float = 105.0         # x8 ranks, intra-DIMM effective
    recnmp_cache_kb: int = 512           # RecNMP explored DIMM caching

    # ---- memory capacity model ----
    local_capacity_frac: float = 0.06    # 128 GB local vs multi-TB tables
    page_bytes: int = 4096
    replan_every_batches: int = 32       # planner cadence (amortizes moves)


# --------------------------- Table III (TCO) -------------------------------


@dataclasses.dataclass(frozen=True)
class CostParams:
    cpu_price: float = 4695.0            # AMD EPYC 9654
    cpu_tdp_w: float = 360.0
    ddr4_per_gb: float = 4.90            # CXL mem (re-purposed DDR4)
    ddr5_per_gb: float = 11.25
    dimm_w_per_64gb_ddr4: float = 21.6
    dimm_w_per_64gb_ddr5: float = 24.0
    nic_price: float = 1900.0            # ConnectX-6 200Gbps
    nic_w: float = 23.6
    switch_price: float = 11899.0        # Juniper QFX10002-36Q
    switch_w: float = 360.0
    switch_pu_price: float = 13039.0     # Tofino-class switch + PUs
    switch_pu_w: float = 400.0
    gpu_price: float = 18900.0           # A100 80GB PCIe
    gpu_w: float = 300.0
    kwh_price: float = 0.05
    years: float = 3.0

    def opex(self, watts: float) -> float:
        hours = self.years * 365 * 24
        return watts / 1000.0 * hours * self.kwh_price


# ------------------- PIFS-Rec silicon overheads (Fig. 18) ------------------


@dataclasses.dataclass(frozen=True)
class SiliconParams:
    pc_mw: float = 9.3
    pc_um2: float = 33709.0
    ctrl_mw: float = 3.2
    ctrl_um2: float = 73114.0
    buffer_mw: float = 15.2
    buffer_um2: float = 2.38e6
    recnmp_x8_mw: float = 75.4
    recnmp_x8_um2: float = 215984.0

    @property
    def pifs_total_mw(self) -> float:
        return self.pc_mw + self.ctrl_mw + self.buffer_mw

    @property
    def pifs_total_um2(self) -> float:
        return self.pc_um2 + self.ctrl_um2 + self.buffer_um2
