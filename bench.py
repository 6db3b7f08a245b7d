#!/usr/bin/env python3
"""Benchmark: genotyping throughput (reads/sec/chip) on the default JAX device.

Workload: synthetic 48 Mb (chr22-scale) genome + 500K SNPs + 101bp reads at the reference's
error/quality profile, streamed through the batched engine on one chip.
Baseline: the reference binary's steady-state streaming rate measured on this
machine (stored in bench_baseline.json; recomputed if absent and the binary
exists), with index-load setup time excluded for fairness.

Prints ONE json line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CACHE = os.environ.get("VGT_BENCH_CACHE", "/tmp/vgt_bench48")
N_READS = int(os.environ.get("VGT_BENCH_READS", 262_144))
GENOME_MB = int(os.environ.get("VGT_BENCH_MB", 48))
N_SNPS = int(os.environ.get("VGT_BENCH_SNPS", 500_000))
BATCH = int(os.environ.get("VGT_BENCH_BATCH", 32768))
READ_LEN = 101  # synthesized read length (write_inputs default; the
                # reference's READ_LEN, vartype.h:16) -- kmer slots and
                # padded length below derive from it so a workload change
                # cannot silently truncate kmers
PASSES = int(os.environ.get("VGT_BENCH_PASSES", 5))
BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "bench_baseline.json")
REF_BINARY = "/tmp/refbuild/vargeno"


def build_dataset():
    os.makedirs(CACHE, exist_ok=True)
    marker = os.path.join(CACHE, "ready2")
    fa = os.path.join(CACHE, "genome.fa")
    vcf = os.path.join(CACHE, "snps.vcf")
    fq = os.path.join(CACHE, "reads.fq")
    if os.path.exists(marker):
        return fa, vcf, fq
    from vargeno_tpu.testing import synth_genome, write_inputs

    rng = np.random.default_rng(20260817)
    genome = synth_genome(rng, sizes=(GENOME_MB * 1_000_000,),
                          names=("chrB1",))
    write_inputs(CACHE, rng, genome, n_snps=N_SNPS, n_reads=N_READS,
                 read_len=READ_LEN, err_frac=0.15)
    open(marker, "w").write("ok")
    return fa, vcf, fq


def build_index(fa, vcf):
    from vargeno_tpu.config import GenoConfig
    from vargeno_tpu.index import store
    from vargeno_tpu.index.build import build_index as bi

    prefix = os.path.join(CACHE, "bench")
    tfile = os.path.join(CACHE, "ibuild.json")
    if store.exists(prefix):
        return store.load(prefix)
    t0 = time.time()
    idx = bi(fa, vcf, prefix)
    try:   # cold-build seconds, reported as the index_build metric
        json.dump({"index_build_s": round(time.time() - t0, 2)},
                  open(tfile, "w"))
    except OSError:
        pass
    return idx


def measure_reference(fa, vcf, fq) -> float:
    """reads/sec of the reference binary, setup time excluded."""
    if os.path.exists(BASELINE_FILE):
        return json.load(open(BASELINE_FILE))["ref_reads_per_sec"]
    if not os.path.exists(REF_BINARY):
        return float("nan")
    prefix = os.path.join(CACHE, "refidx")
    if not os.path.exists(prefix + ".ref.dict"):
        subprocess.run([REF_BINARY, "index", fa, vcf, prefix], check=True,
                       stdout=subprocess.DEVNULL)
    # empty-read run isolates setup (jumpgate init, dict load)
    empty = os.path.join(CACHE, "empty.fq")
    open(empty, "w").close()
    out = os.path.join(CACHE, "ref_out.vcf")

    def timed(reads_file):
        t0 = time.time()
        subprocess.run([REF_BINARY, "geno", prefix, reads_file, vcf, out],
                       check=True, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)
        return time.time() - t0

    timed(empty)            # cold run: page in the 3.6 GB of BF/dict files
    t_setup = timed(empty)  # warm setup (jumpgate init + loads)
    t_full = timed(fq)      # warm full
    n = sum(1 for _ in open(fq)) // 4
    rate = n / max(t_full - t_setup, 1e-3)
    json.dump({"ref_reads_per_sec": rate, "n_reads": n,
               "t_setup": t_setup, "t_full": t_full},
              open(BASELINE_FILE, "w"))
    return rate


def _timed_pass(runner, fq):
    t0 = time.time()
    n0 = runner.n_reads
    runner.consume_fastq(fq)
    np.asarray(runner.ref_cnt)[:1]   # value fetch: the pass has finished
    return (runner.n_reads - n0) / (time.time() - t0)


def _resident_sets(runner, fq, nb: int = 6):
    """nb pre-encoded device-resident batches (the device-rate probe's
    working set; built once, reused by every probe)."""
    import jax
    import jax.numpy as jnp

    from vargeno_tpu import native
    from vargeno_tpu.core.kmer import np_encode_batch
    from vargeno_tpu.io.fastq import iter_read_batches

    cfg = runner.config
    enc = (native.encode_batch if native.available() else np_encode_batch)
    sets = []
    for i, b in enumerate(iter_read_batches(fq, cfg.batch_reads,
                                            cfg.max_read_len,
                                            cfg.max_kmers_per_read)):
        if i >= nb:
            break
        e = enc(b.codes, b.n_kmers, cfg.max_kmers_per_read)
        sets.append(tuple(jnp.asarray(x) for x in e)
                    + (jnp.asarray(b.qual),))
    jax.block_until_ready(sets)
    return sets


def _device_pass(runner, sets, reps: int = 1) -> float:
    """Steady-state DEVICE-step rate: the resident batches dispatched
    back-to-back, one value-fetch sync at the end.  Host-loop- and
    link-independent -- this number moves only when the compiled step
    itself changes OR another process is using the chip, which makes it
    both the perf-regression separator and the
    bench's contention detector."""
    cfg = runner.config
    proc = runner._proc(runner._cfg_run)
    best = 0.0
    for _ in range(reps):
        z, z2 = runner._fresh_counts()
        t0 = time.time()
        for hi, lo, kv, rok, q in sets:
            z, z2, _, _, _ = proc.single_enc(hi, lo, kv, rok, q, z, z2)
        np.asarray(z)[:1]
        best = max(best, len(sets) * cfg.batch_reads / (time.time() - t0))
    return best


def _device_rate(runner, fq, nb: int = 6, reps: int = 3) -> float:
    return _device_pass(runner, _resident_sets(runner, fq, nb), reps)


def pick_runner(index, fq):
    """Build the measurement runner, auto-calibrating the dispatch knobs.

    Candidate (group_size, pipeline_depth) configs are each compiled, warmed
    and timed for one short pass; the fastest wins and the choice is cached
    per (device kind, batch) in the dataset cache so later runs skip straight
    to it. A candidate that fails to build or run fails the bench."""
    import jax

    from vargeno_tpu.config import GenoConfig
    from vargeno_tpu.engine.device_index import build_device_index
    from vargeno_tpu.engine.geno import GenoRunner

    dix = build_device_index(index, ht_target_load=0.24)

    def make(g, depth):
        cfg = GenoConfig(batch_reads=BATCH,
                         max_read_len=max(128, -(-READ_LEN // 32) * 32),
                         # the reference ignores the sub-32 read tail
                         # (qv.cc:779): floor(len/32) kmer slots; extra
                         # slots would be pure padding in every
                         # B*K-proportional gather grid
                         max_kmers_per_read=READ_LEN // 32,
                         ht_target_load=0.24,
                         neighbor_item_frac=0.0834,   # keep NI at 8192
                         probe_active_frac=0.25,      # act max 113,796
                                                      # -> NC 131,072
                         group_size=g, pipeline_depth=depth,
                         # capacities right-sized to MEASURED per-step
                         # maxima on this workload (engine *_lanes_max /
                         # ev_max telemetry; 1.15-4x headroom each) --
                         # every compacted-slot gather pays full lane
                         # cost whether the slot is live or padding, and
                         # auto-retry escalation restores exactness if a
                         # cap ever trips:
                         #   ev_max=4            -> events_per_read=16
                         #   agree_lanes 96,742  -> FA 131,072 (cap 4;
                         #                          cap 3 = 1.6% margin)
                         #   ref/snp scan 3137/5713 -> CS 4915/15974
                         #   probe_lanes 4103    -> NH 6144
                         events_per_read=16,
                         sparse_frac=0.015625,
                         scan_active_frac=0.15,
                         probe_hit_cap=6)
        return GenoRunner(index, cfg, queued_orientation=True, dix=dix)

    dev = jax.devices()[0].device_kind
    calib_key = f"{dev}|{BATCH}|{N_READS}"
    calib_file = os.path.join(CACHE, "calib.json")
    cached = None
    if os.path.exists(calib_file):
        try:
            cal = json.load(open(calib_file))
            if cal.get("key") == calib_key:
                cached = (cal["group"], cal["depth"])
        except Exception:  # noqa: BLE001
            pass

    forced = os.environ.get("VGT_BENCH_GROUP")
    full_cand = [(4, 2), (2, 2), (1, 2), (1, 3)]
    if forced is not None:
        cand = [(int(forced), 2)]
    elif cached is not None:
        cand = [cached]
    elif os.environ.get("VGT_BENCH_CALIBRATE", "1") == "0":
        cand = [(8, 2)]
    else:
        cand = list(full_cand)

    def measure(cand_list, best=None):
        """Time each candidate; any rate <0.5x the running best is re-timed
        once and the max kept (one-off transients must not be cached)."""
        for g, depth in cand_list:
            runner = make(g, depth)
            runner.consume_fastq(fq, limit_batches=max(2, 2 * g))
            rate = _timed_pass(runner, fq)
            if best is not None and rate < 0.5 * best[0]:
                rate2 = _timed_pass(runner, fq)
                print(f"# calib outlier re-check group={g} "
                      f"depth={depth}: {rate:.0f} -> {rate2:.0f}",
                      file=sys.stderr)
                rate = max(rate, rate2)
            print(f"# calib group={g} depth={depth}: "
                  f"{rate:.0f} reads/s", file=sys.stderr)
            if best is None or rate > best[0]:
                best = (rate, g, depth, runner)
        return best

    best = measure(cand)
    if (cached is not None and forced is None
            and best[0] < 0.7 * cal.get("calib_rate", 0)):
        # the cached winner regressed >30% below its recorded rate: either
        # chip/link weather or a stale choice. A device-rate probe (chip
        # only, no host loop) separates the two: if the compiled step
        # itself is running far under its recorded rate, another process
        # is on the chip and re-calibrating would just fit the noise.
        dr = rec_dr = None
        try:
            rec_dr = cal.get("device_rate")
            if rec_dr:
                dr = _device_rate(best[3], fq, nb=4, reps=2)
        except Exception:  # noqa: BLE001 - probe is best-effort
            pass
        if dr is not None and dr < 0.85 * rec_dr:
            print(f"# cached winner {best[0]:.0f} << recorded "
                  f"{cal['calib_rate']:.0f}, but device probe {dr:.0f} << "
                  f"recorded {rec_dr:.0f}: chip contended -- keeping "
                  f"cached calibration", file=sys.stderr)
            return best[3]   # don't overwrite calib.json with noise
        else:
            print(f"# cached winner {best[0]:.0f} << recorded "
                  f"{cal['calib_rate']:.0f}; re-calibrating",
                  file=sys.stderr)
            best = measure([c for c in full_cand
                            if c != (best[1], best[2])], best)
    rate0, g, depth, runner = best
    try:
        dr0 = _device_rate(runner, fq, nb=4, reps=1)
    except Exception:  # noqa: BLE001
        dr0 = None
    try:
        json.dump({"key": calib_key, "group": g, "depth": depth,
                   "calib_rate": round(rate0, 1),
                   "device_rate": round(dr0, 1) if dr0 else None},
                  open(calib_file, "w"))
    except OSError:
        pass
    return runner


def _gather_rates():
    """Measured random-gather lane rates for the gather-bound roofline
    (tools/bench_gather.py, run in this process; cached per device in the
    dataset cache)."""
    import importlib.util

    import jax

    path = os.path.join(CACHE, "gather_rates.json")
    kind = jax.devices()[0].device_kind
    if os.path.exists(path):
        try:
            d = json.load(open(path))
            if d.get("device") == kind:
                return d
        except Exception:  # noqa: BLE001
            pass
    if os.environ.get("VGT_BENCH_GATHER", "1") == "0":
        return None
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_gather", os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "tools", "bench_gather.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        d = mod.measure()
        json.dump(d, open(path, "w"))
        return d
    except Exception as e:  # noqa: BLE001
        print(f"# gather microbench unavailable: {e!r}", file=sys.stderr)
        return None


def _roofline_report(runner, rate):
    import jax

    from vargeno_tpu.utils import roofline

    cfg = runner.config
    st = runner.stats_totals
    lanes = max(runner.n_reads * cfg.max_kmers_per_read, 1)
    lowq_frac = min(st.get("lowq_n", 0) / lanes, 1.0)
    # MEASURED retry fraction (reverse-orientation re-dispatches), not the
    # old 0.25 guess: on this workload ~half the reads are reverse-strand,
    # so the real extra device work is ~1.5-1.65x
    retry_frac = runner.n_retry_reads / max(runner.n_reads, 1)
    return roofline.roofline(cfg, runner.dix,
                             jax.devices()[0].device_kind,
                             cfg.batch_reads, rate,
                             lowq_frac=lowq_frac,
                             retry_frac=retry_frac,
                             gather_rates=_gather_rates())


def main():
    fa, vcf, fq = build_dataset()
    ref_rate = measure_reference(fa, vcf, fq)

    index = build_index(fa, vcf)
    runner = pick_runner(index, fq)

    # median of full passes: a single long pass is exposed to transient
    # throughput swings; the median pass is the steady state.
    #
    # Contention defense: each pass is bracketed by a
    # device-rate probe (resident batches, one sync -- nothing but the chip
    # itself in the loop). A pass whose bracketing probes fall below
    # PROBE_CLEAN_FRAC of the best probe observed ran while another process
    # used the chip; such passes are re-run a bounded number of times and
    # excluded from the median when >=3 clean passes exist. Nothing is
    # silently dropped -- every pass + its probe evidence is printed.
    # 0.96: an observed 277K pass (vs 424K clean) carried bracket probes
    # at 0.92 of best -- mild probe depression + a slow pass means the
    # co-tenant landed mid-pass, so the probe bar must sit well above it
    PROBE_CLEAN_FRAC = float(os.environ.get("VGT_BENCH_CLEAN_FRAC", 0.96))
    MAX_EXTRA = int(os.environ.get("VGT_BENCH_MAX_EXTRA", 6))
    try:
        sets = _resident_sets(runner, fq)
        probe0 = _device_pass(runner, sets, reps=2)
    except Exception as e:  # noqa: BLE001 - defense is best-effort
        print(f"# device probe unavailable: {e!r}", file=sys.stderr)
        sets, probe0 = None, None

    passes = []   # (rate, probe_before, probe_after)
    best_probe = probe0 or 0.0

    def one_pass(prev_probe):
        nonlocal best_probe
        r = _timed_pass(runner, fq)
        # 2 reps (best-of): a single 6-batch probe has ~±3% jitter, right
        # at the clean/polluted bar -- one-rep probes flagged half of one
        # capture's passes for 2-4% dips
        pr = _device_pass(runner, sets, reps=2) if sets is not None else None
        if pr is not None:
            best_probe = max(best_probe, pr)
        passes.append((r, prev_probe, pr))
        return pr

    def clean(p):
        if sets is None:
            return True
        lo = min(x for x in (p[1], p[2]) if x is not None)
        return lo >= PROBE_CLEAN_FRAC * best_probe

    prev = probe0
    for _ in range(PASSES):
        prev = one_pass(prev)
    extra = 0
    while sum(map(clean, passes)) < PASSES and extra < MAX_EXTRA:
        extra += 1
        prev = one_pass(prev)
    rates = [p[0] for p in passes]
    cl = [p[0] for p in passes if clean(p)]
    pool = cl if len(cl) >= 3 else rates
    rate = sorted(pool)[len(pool) // 2]
    for r, pb, pa in passes:
        tag = "clean" if clean((r, pb, pa)) else "POLLUTED"
        pbs = f"{pb:.0f}" if pb is not None else "-"
        pas = f"{pa:.0f}" if pa is not None else "-"
        print(f"# pass {r:8.0f} reads/s  probes [{pbs}, {pas}] "
              f"(best {best_probe:.0f}) -> {tag}", file=sys.stderr)
    print(f"# pass rates: {[round(r) for r in rates]} "
          f"(median of {len(pool)} {'clean ' if pool is cl else ''}passes)",
          file=sys.stderr)
    spread = ((max(pool) - min(pool)) / rate) if rate else 0.0
    ovf = {k: v for k, v in runner.stats_totals.items()
           if "overflow" in k and v}
    if ovf:
        print(f"# WARNING overflows: {ovf}", file=sys.stderr)

    vs = rate / ref_rate if ref_rate == ref_rate else None
    line = {
        "metric": "geno_throughput",
        "value": round(rate, 1),
        "unit": "reads/sec/chip",
        "vs_baseline": round(vs, 3) if vs is not None else None,
        "passes_clean": len(cl),
        "passes_total": len(passes),
        "pass_spread": round(spread, 3),
    }
    try:
        # link-independent companion number (see _device_pass docstring);
        # the best probe IS the cleanest observation of the compiled step
        line["device_rate"] = round(
            best_probe if best_probe else _device_rate(runner, fq), 1)
        line["retry_frac"] = round(
            runner.n_retry_reads / max(runner.n_reads, 1), 3)
        print(f"# device_rate: {line['device_rate']} reads/s "
              f"(retry_frac {line['retry_frac']})", file=sys.stderr)
    except Exception as e:  # noqa: BLE001 - reporting only
        print(f"# device_rate unavailable: {e!r}", file=sys.stderr)
    try:
        # index-build companion metric (vargeno index is half the CLI
        # surface, qv.cc:2239-2389): cold-build seconds recorded when this
        # cache was first built, versus the reference binary's seconds on
        # the same dataset (tools/bench_index_build.py, persisted in
        # bench_baseline.json)
        ib = json.load(open(os.path.join(CACHE, "ibuild.json")))
        line["index_build_s"] = ib["index_build_s"]
        rb = (json.load(open(BASELINE_FILE)).get("ref_index_build_s")
              if os.path.exists(BASELINE_FILE) else None)
        if rb:
            line["index_build_vs"] = round(rb / ib["index_build_s"], 2)
        print(f"# index_build: {line['index_build_s']} s"
              + (f" ({line['index_build_vs']}x the reference binary)"
                 if rb else ""), file=sys.stderr)
    except Exception:  # noqa: BLE001 - cache predates the timing file
        pass
    try:
        rep = _roofline_report(runner, rate)
        print(f"# roofline: {json.dumps(rep)}", file=sys.stderr)
        line["lane_roofline_frac"] = rep["lane_roofline_frac"]
        line["bw_roofline_frac"] = rep["bw_roofline_frac"]
    except Exception as e:  # noqa: BLE001 - roofline is reporting only
        print(f"# roofline unavailable: {e!r}", file=sys.stderr)
    # record the calibration winner so perf regressions are separable from
    # dispatch-link noise
    try:
        cal = json.load(open(os.path.join(CACHE, "calib.json")))
        print(f"# calibration: {json.dumps(cal)}", file=sys.stderr)
    except Exception:  # noqa: BLE001
        pass
    print(json.dumps(line))


if __name__ == "__main__":
    main()
