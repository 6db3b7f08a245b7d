#!/usr/bin/env python3
"""Whole-genome-scale rehearsal.

Builds a ~3 Gb synthetic genome + ~5M-SNP VCF (the reference's headline
workload shape: hg19 + dbSNP-common, /root/reference/experiment/
experiment.md:14-70), runs the full index build, then genotypes a read
sample in sharded-dictionary mode on the virtual CPU mesh. Logs phase
timings + RSS so docs/WORKFLOWS.md can carry measured numbers.

Memory-aware by construction: the genome is generated and written in
chunks as uint8 codes; reads are sliced from the code array directly.

Usage: python tools/rehearse_wgs.py [--mb 3000] [--snps 5000000]
           [--reads 65536] [--cache /tmp/vgt_wgs] [--mesh 4] [--phase all]
"""

import argparse
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the geno phase runs on a virtual CPU mesh (make_mesh(N) requires N
# visible devices)
_MESH = 4
for _i, _a in enumerate(sys.argv):
    if _a == "--mesh" and _i + 1 < len(sys.argv):
        _MESH = int(sys.argv[_i + 1])
os.environ["JAX_PLATFORMS"] = "cpu"
# the oversubscribed CPU mesh can take minutes per giant first step; the
# default 40s collective rendezvous termination timeout hard-aborts it
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count="
                             f"{_MESH}"
                           + " --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
                           + " --xla_cpu_collective_call_terminate_timeout_seconds=7200"
                           + " --xla_cpu_collective_timeout_seconds=7200"
                           ).strip()

T0 = time.time()


def log(msg):
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[{time.time()-T0:8.1f}s rss={rss:6.1f}GB] {msg}", flush=True)


BASES = np.frombuffer(b"ACGT", np.uint8)


def gen_inputs(cache, mb, n_snps, n_reads, read_len=101, seed=20260819):
    fa = os.path.join(cache, "genome.fa")
    vcf = os.path.join(cache, "snps.vcf")
    fq = os.path.join(cache, "reads.fq")
    marker = os.path.join(cache, f"ready_{mb}_{n_snps}_{n_reads}")
    if os.path.exists(marker):
        return fa, vcf, fq
    rng = np.random.default_rng(seed)
    n = mb * 1_000_000
    log(f"generating {mb} Mb genome codes")
    codes = rng.integers(0, 4, n, dtype=np.uint8)

    log("writing FASTA (chunked)")
    W = 70
    with open(fa, "wb") as f:
        f.write(b">chrW1\n")
        CH = 50_000_000 - (50_000_000 % W)
        for i in range(0, n, CH):
            seg = BASES[codes[i:i + CH]]
            m = seg.shape[0]
            pad = (-m) % W
            if pad:
                seg = np.concatenate([seg, np.full(pad, ord("\n"),
                                                   np.uint8)])
            rows = seg.reshape(-1, W)
            out = np.concatenate(
                [rows, np.full((rows.shape[0], 1), ord("\n"), np.uint8)],
                axis=1)
            buf = out.reshape(-1)
            if pad:   # strip pad bytes (newlines already placed)
                buf = np.concatenate([out[:-1].reshape(-1),
                                      rows[-1][:m - (rows.shape[0] - 1) * W],
                                      np.frombuffer(b"\n", np.uint8)])
            f.write(buf.tobytes())

    log(f"writing {n_snps} VCF rows")
    pos = np.sort(rng.choice(np.arange(64, n - 64, dtype=np.int64),
                             size=n_snps, replace=False))
    ref_codes = codes[pos]
    alt_codes = (ref_codes + rng.integers(1, 4, n_snps).astype(np.uint8)) % 4
    caf = rng.choice([0.99, 0.9, 0.7], n_snps)
    with open(vcf, "w") as f:
        f.write("##fileformat=VCFv4.0\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        CH = 500_000
        for i in range(0, n_snps, CH):
            rows = []
            for j in range(i, min(i + CH, n_snps)):
                rows.append(
                    f"chrW1\t{pos[j]+1}\trs{j}\t{chr(BASES[ref_codes[j]])}"
                    f"\t{chr(BASES[alt_codes[j]])}\t.\t.\t"
                    f"RS={j};CAF={caf[j]:.4g},{1-caf[j]:.4g}")
            f.write("\n".join(rows) + "\n")

    log(f"writing {n_reads} reads")
    # alt haplotype: het sites on hap1, hom-alt on both
    gt = rng.choice([0, 1, 2], n_snps, p=[0.5, 0.3, 0.2])
    hap1 = codes.copy()
    sel = gt >= 1
    hap1[pos[sel]] = alt_codes[sel]
    hap0 = codes
    # (hom-alt also on hap0)
    sel2 = gt == 2
    hap0 = codes.copy()
    hap0[pos[sel2]] = alt_codes[sel2]
    comp = np.array([3, 2, 1, 0], np.uint8)
    with open(fq, "wb") as f:
        CH = 8192
        for i in range(0, n_reads, CH):
            m = min(CH, n_reads - i)
            starts = rng.integers(0, n - read_len, m)
            hap = rng.integers(0, 2, m)
            win = starts[:, None] + np.arange(read_len)[None, :]
            r = np.where(hap[:, None] == 0, hap0[win], hap1[win])
            err = rng.random(m) < 0.15
            kidx = rng.integers(0, read_len // 32, m)
            epos = kidx * 32 + rng.integers(0, 32, m)
            es = np.flatnonzero(err)
            r[es, epos[es]] = (r[es, epos[es]]
                               + rng.integers(1, 4, es.size).astype(
                                   np.uint8)) % 4
            rc = rng.random(m) < 0.5
            r = np.where(rc[:, None], comp[r[:, ::-1]], r)
            qual = np.full((m, read_len), ord("I"), np.uint8)
            qual[es, kidx[es]] = ord("0")
            seqs = BASES[r]
            for j in range(m):
                f.write(b"@r%d\n" % (i + j))
                f.write(seqs[j].tobytes() + b"\n+\n")
                f.write(qual[j].tobytes() + b"\n")
    del hap0, hap1, codes
    open(marker, "w").write("ok")
    log("inputs ready")
    return fa, vcf, fq


def _read_genome_codes(fa):
    """FASTA -> uint8 codes (single-sequence file written by gen_inputs)."""
    raw = np.fromfile(fa, np.uint8)
    start = int(np.flatnonzero(raw == ord("\n"))[0]) + 1
    body = raw[start:]
    body = body[body != ord("\n")]
    codes = np.full(body.shape[0], 4, np.uint8)
    for i, b in enumerate(b"ACGT"):
        codes[body == b] = i
    return codes


def gen_extra_reads(cache, fa, vcf, n_reads, read_len=101, seed=77):
    """More reads from the EXISTING genome + VCF (a fresh genotype
    assignment) without touching the cached index: the exactness check is
    oracle parity on the same reads, not a predetermined truth set."""
    fq = os.path.join(cache, f"reads_{n_reads}.fq")
    if os.path.exists(fq):
        return fq
    rng = np.random.default_rng(seed)
    log(f"extra reads: loading genome codes from {fa}")
    codes = _read_genome_codes(fa)
    n = codes.shape[0]
    log("extra reads: parsing VCF positions")
    pos_l, alt_l = [], []
    lut = {b"A"[0]: 0, b"C"[0]: 1, b"G"[0]: 2, b"T"[0]: 3}
    with open(vcf, "rb") as f:
        for line in f:
            if line.startswith(b"#"):
                continue
            parts = line.split(b"\t", 5)
            pos_l.append(int(parts[1]) - 1)
            alt_l.append(lut[parts[4][0]])
    pos = np.asarray(pos_l, np.int64)
    alt_codes = np.asarray(alt_l, np.uint8)
    gt = rng.choice([0, 1, 2], pos.shape[0], p=[0.5, 0.3, 0.2])
    hap1 = codes.copy()
    sel = gt >= 1
    hap1[pos[sel]] = alt_codes[sel]
    hap0 = codes.copy()
    sel2 = gt == 2
    hap0[pos[sel2]] = alt_codes[sel2]
    comp = np.array([3, 2, 1, 0], np.uint8)
    log(f"extra reads: writing {n_reads}")
    with open(fq, "wb") as f:
        CH = 8192
        for i in range(0, n_reads, CH):
            m = min(CH, n_reads - i)
            starts = rng.integers(0, n - read_len, m)
            hap = rng.integers(0, 2, m)
            win = starts[:, None] + np.arange(read_len)[None, :]
            r = np.where(hap[:, None] == 0, hap0[win], hap1[win])
            err = rng.random(m) < 0.15
            kidx = rng.integers(0, read_len // 32, m)
            epos = kidx * 32 + rng.integers(0, 32, m)
            es = np.flatnonzero(err)
            r[es, epos[es]] = (r[es, epos[es]]
                               + rng.integers(1, 4, es.size).astype(
                                   np.uint8)) % 4
            rc = rng.random(m) < 0.5
            r = np.where(rc[:, None], comp[r[:, ::-1]], r)
            qual = np.full((m, read_len), ord("I"), np.uint8)
            qual[es, kidx[es]] = ord("0")
            seqs = BASES[r]
            for j in range(m):
                f.write(b"@x%d\n" % (i + j))
                f.write(seqs[j].tobytes() + b"\n+\n")
                f.write(qual[j].tobytes() + b"\n")
    del hap0, hap1, codes
    log("extra reads ready")
    return fq


def spot_parity(index, runner, fq, n_spot, seed=11):
    """Oracle spot-parity at full WGS scale: sample n_spot reads, stream
    them through the SAME sharded-dict mesh runner (fresh accumulators),
    run the sequential oracle spec on the identical reads, and compare
    per-site saturated counts exactly."""
    import numpy as np

    cache_dir = os.path.dirname(fq)
    spot = os.path.join(cache_dir, f"spot_{n_spot}.fq")
    rng = np.random.default_rng(seed)
    lines = open(fq, "rb").read().splitlines(keepends=True)
    recs = [lines[i:i + 4] for i in range(0, len(lines) - 3, 4)]
    sel = rng.choice(len(recs), size=min(n_spot, len(recs)), replace=False)
    with open(spot, "wb") as f:
        for i in sorted(sel):
            f.writelines(recs[i])
    log(f"spot parity: {len(sel)} reads -> engine (mesh)")
    runner.ref_cnt, runner.alt_cnt = runner._fresh_counts()
    runner.stats_totals = {}
    runner.consume_fastq(spot)
    rc_e, ac_e = runner._host_counts()
    mc = runner.config.max_cov
    s = index.sites
    n = s.pos.shape[0]
    rc_e = np.minimum(rc_e[:n], mc)
    ac_e = np.minimum(ac_e[:n], mc)
    log("spot parity: oracle (fork-parallel)")
    from vargeno_tpu.oracle import OracleEngine

    eng = OracleEngine(index)
    eng.run_fastq_parallel(spot)
    rc_o = np.array([eng.pileup[int(p)][4] for p in s.pos], np.int64)
    ac_o = np.array([eng.pileup[int(p)][5] for p in s.pos], np.int64)
    bad = np.flatnonzero((rc_e != rc_o) | (ac_e != ac_o))
    if bad.size:
        log(f"SPOT PARITY FAIL: {bad.size} sites differ; first "
            f"{[(int(s.pos[i]), int(rc_e[i]), int(rc_o[i]), int(ac_e[i]), int(ac_o[i])) for i in bad[:5]]}")
        raise SystemExit(1)
    log(f"SPOT PARITY PASS: {len(sel)} reads, "
        f"{int(np.sum(rc_o) + np.sum(ac_o))} site-count increments, "
        f"0 mismatches over {n} sites")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=3000)
    ap.add_argument("--snps", type=int, default=5_000_000)
    ap.add_argument("--reads", type=int, default=65_536)
    ap.add_argument("--extra-reads", type=int, default=0,
                    help="generate + stream an additional reads_{N}.fq "
                         "from the existing genome/VCF (index untouched)")
    ap.add_argument("--spot-parity", type=int, default=0,
                    help="after geno, verify N sampled reads' counts "
                         "against the sequential oracle spec")
    ap.add_argument("--cache", default="/tmp/vgt_wgs")
    ap.add_argument("--mesh", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--limit-batches", type=int, default=2)
    ap.add_argument("--phase", default="all",
                    choices=["all", "gen", "index", "geno"])
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path prefix (resume-on-restart); "
                         "endurance kill/resume runs use this")
    ap.add_argument("--checkpoint-every", type=int, default=16)
    ap.add_argument("--out", default="out.vcf",
                    help="output VCF filename inside the cache dir")
    ap.add_argument("--progress-every", type=float, default=30.0,
                    help="seconds between progress log lines (0=off)")
    args = ap.parse_args()

    os.makedirs(args.cache, exist_ok=True)
    fa, vcf, fq = gen_inputs(args.cache, args.mb, args.snps, args.reads)
    if args.phase == "gen":
        return

    prefix = os.path.join(args.cache, "wgs")
    from vargeno_tpu.index import store

    if args.phase in ("all", "index") and not store.exists(prefix):
        log("index build: start")
        from vargeno_tpu.index.build import build_index

        build_index(fa, vcf, prefix)
        log("index build: done")
    if args.phase == "index":
        return

    log("loading index (mmap)")
    index = store.load(prefix)
    log(f"index loaded: {index.ref.kmers.shape[0]} ref rows, "
        f"{index.snp.kmers.shape[0]} snp rows")

    import jax

    from vargeno_tpu.config import GenoConfig
    from vargeno_tpu.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu.dist.sharding import make_mesh

    if args.extra_reads:
        fq = gen_extra_reads(args.cache, fa, vcf, args.extra_reads)

    cfg = GenoConfig(batch_reads=args.batch, max_read_len=128,
                     max_kmers_per_read=4, events_per_read=24)
    mesh = make_mesh(args.mesh)
    log(f"building sharded-dict runner over {args.mesh} devices")
    runner = ShardedDictGenoRunner(index, mesh, cfg)
    log("runner ready; streaming reads")
    t0 = time.time()
    n0 = runner.n_reads
    stop_progress = None
    if args.progress_every:
        import threading

        ev = threading.Event()

        def _progress():
            last_n, last_t = runner.n_reads, time.time()
            while not ev.wait(args.progress_every):
                n, t = runner.n_reads, time.time()
                log(f"progress: {n} reads total, "
                    f"{(n - last_n) / max(t - last_t, 1e-9):.0f} reads/s "
                    f"over the last {t - last_t:.0f}s")
                last_n, last_t = n, t

        threading.Thread(target=_progress, daemon=True).start()
        stop_progress = ev.set
    runner.consume_fastq(fq, limit_batches=args.limit_batches or None,
                         checkpoint_path=args.checkpoint,
                         checkpoint_every=args.checkpoint_every)
    jax.block_until_ready(runner.ref_cnt)
    if stop_progress:
        stop_progress()
    dt = time.time() - t0
    log(f"geno done: {runner.n_reads} reads in {dt:.1f}s "
        f"({(runner.n_reads-n0)/dt:.0f} reads/s on the virtual mesh), "
        f"stats={runner.stats_totals}")
    out = os.path.join(args.cache, args.out)
    runner.write_vcf(vcf, out)
    log(f"vcf written: {sum(1 for _ in open(out))} lines")
    if args.spot_parity:
        spot_parity(index, runner, fq, args.spot_parity)


if __name__ == "__main__":
    main()
