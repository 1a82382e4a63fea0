"""Trace-driven latency model for the five systems the paper compares.

A copy of ``repro.simlab.simulator``: numpy on the host, with the
buffer and LLC models of ``repro_torch.core.hot_cache`` walked one access
at a time in Python, as in the reference, so every ``SimResult`` equals
the reference's field for field.  It is a model of the paper's hardware,
not a workload for the card.

Methodology (paper §VI-A, adapted from Ramulator cycle simulation to an
analytic resource model): a trace of SLS row accesses is pushed through a
system description; every shared resource accumulates bytes; the batch
latency is the *binding* resource's service time plus serial terms.

The physics the model encodes (each is a paper observation):

  * **Host-centric CXL reads are latency-limited** (Key Takeaway 1; "fetching
    a single address from memory pools can take up to 270 ns").  A host
    keeps only `outstanding` line fetches in flight, so its effective CXL
    bandwidth is  outstanding x row_bytes / round_trip  — well below the
    link rate.  Round-trip grows with switch fan-out and device imbalance
    ("flex bus congestion under heavy memory traffic").  This is what makes
    Pond slow and what near-data processing removes.
  * **In-switch compute is bandwidth-limited** — the switch is the requester
    (short loop, many outstanding DMAs), so PIFS/BEACON stream at DDR4 media
    bandwidth per device; the PC accumulate datapath has a fixed width
    (`pc_GBs`), and without OoO it stalls on interleaved bags (Fig. 12e).
  * **Only pooled results cross the upstream link** for switch-compute
    systems; host-centric systems ship every row.
  * **Placement**: hot-aware promotion + spreading (PM) vs address-
    interleaved capacity (Pond) vs all-CXL (BEACON) vs all-local-DIMM
    (RecNMP).  Placement is decided on the *first half* of the trace and
    evaluated on the second (production traces drift; a stationary
    evaluation would overstate PM).
  * **On-switch buffer**: row-granular cache simulation (HTR/LRU/FIFO from
    core/hot_cache.py) over the CXL-row stream.

Systems:
  pond / pond_pm / beacon / recnmp / pifs (+ ablation flags, Fig. 12e).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.hot_cache import make_policy
from repro_torch.simlab.devices import HardwareParams


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    name: str
    in_switch_compute: bool = False      # PC in the fabric switch
    page_mgmt: bool = False              # hot-tier promotion + spreading
    buffer_kb: int = 0                   # on-switch SRAM buffer size
    buffer_policy: str = "htr"
    ooo: bool = False                    # out-of-order accumulation
    all_cxl: bool = False                # BEACON: no local-DRAM interleave
    translate_factor: float = 1.0        # BEACON memory-translation slowdown
    pnm: bool = False                    # RecNMP: DIMM-side processing
    migration_granularity: str = "line"  # "line" | "page" (Fig. 13a/d)


def pond(pm: bool = False) -> SystemConfig:
    return SystemConfig(name="pond_pm" if pm else "pond", page_mgmt=pm)


def beacon(hw: HardwareParams) -> SystemConfig:
    return SystemConfig(name="beacon", in_switch_compute=True, all_cxl=True,
                        translate_factor=hw.beacon_translate_factor)


def recnmp(hw: HardwareParams) -> SystemConfig:
    return SystemConfig(name="recnmp", pnm=True,
                        buffer_kb=hw.recnmp_cache_kb, buffer_policy="htr")


def pifs(hw: HardwareParams, *, pc: bool = True, pm: bool = True,
         buffer_kb: Optional[int] = None, ooo: bool = True,
         buffer_policy: str = "htr",
         migration_granularity: str = "line") -> SystemConfig:
    return SystemConfig(
        name="pifs", in_switch_compute=pc, page_mgmt=pm,
        buffer_kb=hw.buffer_kb_default if buffer_kb is None else buffer_kb,
        ooo=ooo, buffer_policy=buffer_policy,
        migration_granularity=migration_granularity)


ALL_SYSTEMS = ("pond", "pond_pm", "beacon", "recnmp", "pifs")


def make_system(name: str, hw: HardwareParams) -> SystemConfig:
    return {
        "pond": lambda: pond(False),
        "pond_pm": lambda: pond(True),
        "beacon": lambda: beacon(hw),
        "recnmp": lambda: recnmp(hw),
        "pifs": lambda: pifs(hw),
    }[name]()


@dataclasses.dataclass
class SimResult:
    system: str
    total_us: float
    components_us: Dict[str, float]
    binding: str
    frac_local_access: float
    buffer_hit_rate: float
    device_imbalance: float
    migration_cost_us: float
    device_loads: np.ndarray

    def speedup_over(self, other: "SimResult") -> float:
        return other.total_us / self.total_us


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def _place_pages(page_counts: np.ndarray, n_pages_local: int, n_devices: int,
                 hot_aware: bool, spread: bool, all_cxl: bool,
                 balance_counts: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (is_local (P,) bool, device (P,) int; device=-1 for local).

    `balance_counts`: the counts the *spreading* step balances against.  Hot
    promotion uses the (stale) profiling counts — page-temperature ranking
    lags; spreading reacts to node-level warmness online (the paper's
    migrate_threshold fires during the run), so it sees fresher counts.
    """
    P = page_counts.shape[0]
    is_local = np.zeros(P, dtype=bool)
    if not all_cxl and n_pages_local > 0:
        if hot_aware:
            hot = np.argsort(-page_counts, kind="stable")[:n_pages_local]
        else:
            # address-interleaved capacity: an even stride over the address
            # space — uncorrelated with hotness (Pond's default mapping)
            stride = max(1, P // max(n_pages_local, 1))
            hot = np.arange(0, P, stride)[:n_pages_local]
        is_local[hot] = True
    cold = np.nonzero(~is_local)[0]
    device = np.full(P, -1, dtype=np.int64)
    if spread:
        # weighted LPT over access counts (the embedding-spreading planner);
        # round-robin in descending-count order is the vectorized equivalent
        bc = balance_counts if balance_counts is not None else page_counts
        order = cold[np.argsort(-bc[cold], kind="stable")]
        device[order] = np.arange(order.size) % n_devices
    else:
        device[cold] = cold % n_devices
    return is_local, device


# ---------------------------------------------------------------------------
# Simulation
# ---------------------------------------------------------------------------


def simulate(row_ids: np.ndarray, row_bytes: int, pooling: int,
             sys: SystemConfig, hw: Optional[HardwareParams] = None,
             n_rows_total: Optional[int] = None,
             n_devices: Optional[int] = None,
             local_capacity_frac: Optional[float] = None,
             seed: int = 0) -> SimResult:
    """row_ids: flat (N,) global row access stream (bag-major: consecutive
    groups of `pooling` ids form one bag).

    The first half of the stream is the profiling epoch (placement input);
    metrics are measured on the second half (drift-honest evaluation).
    """
    hw = hw or HardwareParams()
    D = n_devices if n_devices is not None else hw.n_devices
    cap_frac = (local_capacity_frac if local_capacity_frac is not None
                else hw.local_capacity_frac)
    N_all = row_ids.shape[0]
    half = (N_all // 2 // pooling) * pooling
    profile_ids, eval_ids = row_ids[:half], row_ids[half:]
    N = eval_ids.shape[0]
    n_rows_total = n_rows_total or int(row_ids.max()) + 1
    rows_per_page = max(1, hw.page_bytes // row_bytes)
    n_pages = -(-n_rows_total // rows_per_page)

    prof_counts = np.bincount(profile_ids // rows_per_page,
                              minlength=n_pages).astype(np.float64)
    pages = eval_ids // rows_per_page
    eval_counts = np.bincount(pages, minlength=n_pages).astype(np.float64)

    # ---- placement (hot tier from the profiling epoch; spreading balances
    # against a profile/eval blend — it re-fires online) --------------------
    if sys.pnm:
        is_local = np.ones(n_pages, dtype=bool)
        device = np.full(n_pages, -1, dtype=np.int64)
    else:
        n_local = 0 if sys.all_cxl else int(n_pages * cap_frac)
        is_local, device = _place_pages(
            prof_counts, n_local, D,
            hot_aware=sys.page_mgmt, spread=sys.page_mgmt,
            all_cxl=sys.all_cxl,
            balance_counts=0.5 * prof_counts + 0.5 * eval_counts)

    acc_local = is_local[pages]
    frac_local = float(acc_local.mean())

    # ---- on-switch buffer over the CXL-row stream -------------------------
    hit = np.zeros(N, dtype=bool)
    hit_rate = 0.0
    if sys.buffer_kb > 0:
        capacity_rows = max(1, sys.buffer_kb * 1024 // row_bytes)
        policy = make_policy(sys.buffer_policy, capacity_rows)
        stream_idx = np.arange(N) if sys.pnm else np.nonzero(~acc_local)[0]
        if stream_idx.size:
            # warm the policy on the profiling epoch's miss stream
            warm = profile_ids if sys.pnm else \
                profile_ids[~is_local[profile_ids // rows_per_page]]
            for r in warm[-4 * capacity_rows:]:
                policy.access(int(r))
            hits = np.fromiter((policy.access(int(eval_ids[i]))
                                for i in stream_idx), dtype=bool,
                               count=stream_idx.size)
            hit[stream_idx] = hits
            hit_rate = float(hits.mean())

    # ---- byte accounting ---------------------------------------------------
    raw_bytes = float(N * row_bytes)
    n_bags = N // max(pooling, 1)
    pooled_bytes = float(n_bags * row_bytes)

    local_bytes = float(acc_local.sum() * row_bytes)
    sram_bytes = float(hit.sum() * row_bytes)
    cxl_mask = ~acc_local & ~hit
    cxl_rows = int(cxl_mask.sum())
    cxl_bytes = float(cxl_rows * row_bytes)

    dev_loads = np.zeros(D)
    if cxl_rows and not sys.pnm:
        acc_dev = device[pages[cxl_mask]]
        dev_loads = np.bincount(acc_dev, minlength=D
                                ).astype(np.float64) * row_bytes
    imbalance = float(dev_loads.max() / max(dev_loads.mean(), 1e-9)) \
        if dev_loads.sum() else 1.0

    G = 1e9
    comp: Dict[str, float] = {}

    # round-trip a host-issued CXL line fetch sees: DRAM + CXL penalty +
    # switch traversal, inflated by fan-out congestion and hot-port queueing
    congest = 1.0 + hw.switch_congestion * max(0, D - 4) * imbalance ** 2
    rt_ns = (hw.lat_local_ns + hw.lat_cxl_extra_ns + hw.lat_proto_ns
             + hw.lat_switch_ns * congest
             + hw.lat_queue_ns * max(0.0, imbalance - 1.0))

    if sys.pnm:
        miss_bytes = raw_bytes - sram_bytes
        comp["dimm"] = miss_bytes / (hw.bw_recnmp_GBs * G)
        # per-DIMM caches are rank-parallel; hits are effectively free at
        # rank aggregate SRAM bandwidth
        comp["sram"] = sram_bytes / (hw.bw_sram_GBs * 8 * G)
        comp["upstream"] = pooled_bytes / (hw.bw_upstream_GBs * G)
    else:
        comp["local"] = local_bytes / (hw.bw_local_GBs * G)
        # CXL devices stream at DDR4 media bandwidth behind the port
        comp["device_max"] = float(dev_loads.max()) / (hw.bw_media_GBs * G)
        comp["sram"] = sram_bytes / (hw.bw_sram_GBs * G)
        if sys.in_switch_compute:
            comp["upstream"] = pooled_bytes / (hw.bw_upstream_GBs * G)
            pc_time = (cxl_bytes + sram_bytes) / (hw.pc_GBs * G)
            if not sys.ooo:
                pc_time /= (1.0 - hw.ooo_stall_free_frac)
            comp["pc"] = pc_time
            # translation logic serializes ahead of the device issue path
            comp["device_max"] *= sys.translate_factor
        else:
            # host-centric: every CXL row is a host-issued line fetch.  The
            # host LLC (dual Genoa ~768 MB L3; modeled at host_cache_mb)
            # absorbs re-referenced rows regardless of page placement — the
            # reason PM helps Pond only marginally in the paper.
            cache_rows = max(1, hw.host_cache_mb * 2 ** 20 // row_bytes)
            llc = make_policy("lru", cache_rows)
            cxl_idx = np.nonzero(~acc_local)[0]
            warm_rows = profile_ids[~is_local[profile_ids // rows_per_page]]
            for r in warm_rows[-2 * cache_rows:]:
                llc.access(int(r))
            llc_hits = np.fromiter(
                (llc.access(int(eval_ids[i])) for i in cxl_idx),
                dtype=bool, count=cxl_idx.size)
            llc_hit_bytes = float(llc_hits.sum() * row_bytes)
            hit_rate = float(llc_hits.mean()) if cxl_idx.size else 0.0
            miss_bytes = cxl_bytes + sram_bytes - llc_hit_bytes
            # latency-limited effective bandwidth, capped by the link.
            # Fetches are cache-line (64 B) granular: a 128 B row is two
            # pipelined line fills, so effective bytes/s is row-size
            # independent
            eff_bw = min(hw.bw_upstream_GBs * G,
                         hw.outstanding * 64.0 / (rt_ns / 1e9))
            comp["upstream"] = miss_bytes / eff_bw
            comp["llc"] = llc_hit_bytes / (hw.bw_local_GBs * G)
            comp["host_reduce"] = (N * hw.host_reduce_ns_per_row) / 1e9

    # ---- serial terms ------------------------------------------------------
    lat_ns = hw.lat_local_ns * frac_local + rt_ns * (1.0 - frac_local)
    fill = lat_ns * 1e-9  # one pipeline fill per batch

    mig = 0.0
    if sys.page_mgmt and not sys.pnm:
        # one re-plan moves ~10% of the hot set; it is amortized over the
        # batches between re-plans (planner default cadence)
        n_local_pages = int(is_local.sum())
        moved_pages = max(1, int(0.1 * n_local_pages))
        page_move = moved_pages * hw.page_bytes / (hw.bw_media_GBs * G)
        mig = page_move / (5.1 if sys.migration_granularity == "line"
                           else 1.0)
        mig /= hw.replan_every_batches
    comp["migration"] = mig

    total = max(comp.values()) + fill + mig
    binding = max(comp, key=comp.get)
    return SimResult(
        system=sys.name,
        total_us=total * 1e6,
        components_us={k: v * 1e6 for k, v in comp.items()},
        binding=binding,
        frac_local_access=frac_local,
        buffer_hit_rate=hit_rate,
        device_imbalance=imbalance,
        migration_cost_us=mig * 1e6,
        device_loads=dev_loads,
    )


# ---------------------------------------------------------------------------
# End-to-end model-level weighting (Fig. 14)
# ---------------------------------------------------------------------------


def e2e_speedup(sls_speedup: float, sls_fraction: float) -> float:
    """Amdahl weighting of SLS vs non-SLS operators (§VI-C4)."""
    return 1.0 / ((1.0 - sls_fraction) + sls_fraction / sls_speedup)


def sls_fraction_for(model_cfg, batch: int, hw: Optional[HardwareParams] = None
                     ) -> float:
    """SLS share of end-to-end time for a DLRM config: MLP FLOPs at host
    throughput vs SLS bytes at the host's effective CXL bandwidth."""
    hw = hw or HardwareParams()
    dims_b = (model_cfg.n_dense,) + model_cfg.bottom_mlp
    dims_t = model_cfg.top_mlp
    F = model_cfg.n_tables + 1
    inter_in = F * (F - 1) // 2 + model_cfg.emb_dim
    mlp_flops = 0
    for a, b in zip(dims_b[:-1], dims_b[1:]):
        mlp_flops += 2 * a * b
    mlp_flops += 2 * inter_in * dims_t[0]
    for a, b in zip(dims_t[:-1], dims_t[1:]):
        mlp_flops += 2 * a * b
    mlp_flops *= batch
    host_flops = 2.0e12                    # dual-socket Genoa, ~2 TFLOP/s eff
    t_mlp = mlp_flops / host_flops
    sls_bytes = (batch * model_cfg.n_tables * model_cfg.pooling
                 * model_cfg.emb_dim * 4)
    t_sls = sls_bytes / (hw.bw_upstream_GBs * 1e9)
    return t_sls / (t_sls + t_mlp)
