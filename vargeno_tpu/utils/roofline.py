"""Roofline accounting for the genotyping inner loop.

Two bounds are computed for a given engine configuration + measured
per-batch telemetry:

1. ``bytes`` bound -- device-memory traffic over the device's published
   peak bandwidth (``DEVICE_HBM_GBPS``, keyed by ``device_kind``; a device
   missing from the table is an error, never a default).
2. ``lane`` bound -- per-step gather/scatter/sort lane counts divided by
   per-lane rates MEASURED on the device by tools/bench_gather.py. There
   is no built-in rate table: without a measurement the lane terms are
   reported as not measured (None).

Reference for the semantics being accounted: the reference's hot loop is
the same algorithm as pointer chases (src/qv.cc:834-1367).
"""

from __future__ import annotations

import dataclasses


# published peak device-memory bandwidth, GB/s, by jax device_kind
DEVICE_HBM_GBPS = {
    # NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU data sheet)
    "NVIDIA H100 80GB HBM3": 3350.0,
}

# bench_gather.measure() key for each lane-rate family; row128 shares the
# 128 B row measurement
_MEASURED_KEYS = dict(word="word_gather_1048576", row="row_gather_1048576",
                      row128="row_gather_1048576",
                      row512="row_gather_512B", scatter="scatter_rows",
                      scalar="scatter_scalar", sort="device_sort_u32")


def device_hbm_gbps(device_kind: str) -> float:
    try:
        return DEVICE_HBM_GBPS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published memory bandwidth for device kind "
            f"{device_kind!r}; add it to DEVICE_HBM_GBPS with its "
            f"source") from None


def device_lane_rates(measured: dict | None = None) -> dict:
    """word/row/scatter/... lanes-per-second from a bench_gather.measure()
    result; every rate without a measurement is None (not measured)."""
    measured = measured or {}
    return {fam: measured.get(key) for fam, key in _MEASURED_KEYS.items()}


@dataclasses.dataclass
class StepTraffic:
    """Per-single-orientation-step traffic model. Each term mirrors one
    gather/scatter/sort family in engine/batch.py; `lowq_frac` comes from
    the engine's own telemetry so the model tracks the actual workload.

    Row lanes are split by width family (<=128 B window/aux rows against
    512 B bucket rows) because bench_gather measures each family's rate
    on its own. Narrow-row gathers (8-16 B rows: packed meta pairs, scan
    tests) are counted in ``word_lanes``."""

    bytes_total: float
    word_lanes: float
    row128_lanes: float    # narrow rows (window/aux gathers)
    row512_lanes: float    # 512 B bucket rows (exact probes)
    scalar_lanes: float    # scalar-element scatter source lanes
    sort_keys: float       # u32 keys through sort-based compactions
    detail: dict


def step_traffic(cfg, dix, B: int, lowq_frac: float = 0.05) -> StepTraffic:
    K = cfg.max_kmers_per_read
    chain = dix.both_ht_chain
    row_b = dix.both_ht.shape[1] * 4
    NI = max(8, int(B * K * cfg.neighbor_item_frac))
    NH = max(64, NI * cfg.probe_hit_cap // 8)
    E = cfg.events_per_read
    FA = max(64, B * cfg.agree_cap)
    no_big = dix.ref_scan_max < cfg.block_size_threshold
    PG = 64 if no_big else 128       # neighbor key grid columns
    NC = max(64, int(NI * PG * cfg.probe_active_frac))
    scan_r = min(cfg.scan_slot_cap, getattr(dix, "ref_scan_max", 100))
    scan_s = min(cfg.scan_slot_cap, getattr(dix, "snp_scan_max", 100))
    # scan-stage gathers run on the COMPACTED test-lane grids (backend.
    # _scan_lanes), not the full (NI, S) grids
    CS_r = max(64, int(NI * scan_r * min(cfg.scan_active_frac, 1.0)))
    CS_s = max(64, int(NI * scan_s * min(cfg.scan_active_frac, 1.0)))
    NA = max(64, B // 4)
    NAX = max(64, 4 * NA)
    NSE = max(64, int(B * (E + 1) * cfg.sparse_events_frac))

    # (word_lanes, row128_lanes, row512_lanes, scalar_lanes, sort_keys,
    #  bytes)
    d = {}
    d["exact"] = (0, 0, B * K * chain, 0, 0, B * K * chain * row_b)
    d["bounds"] = (NI * 2, NI * dix.ref_win_rows, 0, 0, 0,
                   NI * (8 + dix.ref_win_rows * 128))
    d["bf"] = (NI * 2, 0, 0, 0, 0, NI * 8)
    # per compacted test lane: ref scan = ref_lo word + meta 8 B row;
    # snp scan = snp_test 8 B row + meta 8 B row
    d["scan"] = (CS_r * 2 + CS_s * 2, 0, 0, 0, 0, CS_r * 12 + CS_s * 16)
    # probe stage: key-pair row gather on NC compacted lanes, direct
    # bucket lookup (512 B rows), 3-word scalar scatter-back
    d["probe"] = (NC, 0, NC * chain, 3 * NC, 0,
                  NC * 8 + NC * chain * row_b)
    d["aux"] = (0, NH, 0, 0, 0, NH * 80)
    # events: ref+snp exact scatter densely (B*2K); aux + neighbor events
    # are compacted first; every record is 2 scalar word scatters
    d["events"] = (0, NAX + NSE, 0, 2 * (B * 2 * K + NAX + NSE), 0,
                   B * (E + 1) * 8 + (NAX + NSE) * 28)
    d["vote"] = (0, 0, 0, 0, 0, E * B * 8)        # event stream read once
    d["pileup"] = (2 * FA + FA // 2, 2 * FA, 0, FA, 0,
                   FA * 36 + (FA // 2) * 12)
    # sort-based compactions: items + probe hits + amb + aux + sparse
    # events + agree contexts + site hits + active probe lanes + scan grids
    d["compact"] = (0, 0, 0, 0,
                    B * K + NI * (PG * 2 + scan_r + scan_s) + B * K * 2
                    + NA * 10 + NH * 10 + B * E + FA * cfg.sites_per_context
                    + NI * PG, 0)

    w = float(sum(v[0] for v in d.values()))
    r1 = float(sum(v[1] for v in d.values()))
    r5 = float(sum(v[2] for v in d.values()))
    s = float(sum(v[3] for v in d.values()))
    so = float(sum(v[4] for v in d.values()))
    byts = float(sum(v[5] for v in d.values()))
    return StepTraffic(bytes_total=byts, word_lanes=w, row128_lanes=r1,
                       row512_lanes=r5, scalar_lanes=s, sort_keys=so,
                       detail=d)


def roofline(cfg, dix, device_kind: str, B: int,
             measured_reads_per_sec: float,
             lowq_frac: float = 0.05,
             retry_frac: float = 0.25,
             gather_rates: dict | None = None) -> dict:
    """Roofline report for the bench output. retry_frac: extra device work
    from reverse-orientation retry batches."""
    tr = step_traffic(cfg, dix, B, lowq_frac=lowq_frac)
    mult = (1.0 + retry_frac) / B
    bw = device_hbm_gbps(device_kind) * 1e9
    rates = device_lane_rates(gather_rates)
    terms = ((tr.word_lanes, "word"), (tr.row128_lanes, "row128"),
             (tr.row512_lanes, "row512"), (tr.scalar_lanes, "scalar"),
             (tr.sort_keys, "sort"))
    lane_bound = None
    if all(rates[fam] for _, fam in terms):
        lane_bound = 1.0 / (sum(n / rates[fam] for n, fam in terms) * mult)
    bytes_per_read = tr.bytes_total * mult
    bw_bound = bw / bytes_per_read
    out = dict(
        device=device_kind,
        bytes_per_read=round(bytes_per_read, 1),
        lanes_per_read={fam: round(n * mult, 1) for n, fam in terms},
        bw_bound_reads_per_sec=round(bw_bound, 0),
        lane_bound_reads_per_sec=(round(lane_bound, 0) if lane_bound
                                  else None),
        achieved_reads_per_sec=round(measured_reads_per_sec, 1),
        bw_roofline_frac=round(measured_reads_per_sec / bw_bound, 4),
        lane_roofline_frac=(round(measured_reads_per_sec / lane_bound, 4)
                            if lane_bound else None),
    )
    return out
