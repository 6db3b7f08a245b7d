#!/usr/bin/env python3
"""On-card smoke test: the genotyper's main path on NVIDIA GPUs.

    python chip_smoke.py          # one card: golden parity, a chr22-scale
                                  # deployment with oracle spot parity, and
                                  # the engine's primitives at real widths
    python chip_smoke.py --four   # only the 4-card mesh runs (--mesh 4,
                                  # --mesh 4 --sharded-dict) and what they
                                  # are compared with

Every phase is a function; any failed phase makes the exit code non-zero.
There is no CPU fallback: without a GPU the script exits non-zero and
prints no result. Generated data, indexes and outputs go to build/smoke/
(gitignored); the chr22-scale dataset is reused while its marker exists.
The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(REPO, "tests", "fixtures", "mini")
WORK = os.path.join(REPO, "build", "smoke")

# the chr22-scale deployment (BASELINE.json "chr22 full"): 48 Mb genome,
# 500K SNPs, 262,144 reads of 101 bp with a 15% one-error-per-read rate
REAL = dict(seed=20260817, genome_bp=48_000_000, n_snps=500_000,
            n_reads=262_144, read_len=101, err_frac=0.15, batch=32768)
SPOT_READS = 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e!r})"
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _fresh(path: str) -> str:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _cli(argv):
    from vargeno_tpu import cli

    rc = cli._main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")


def _cli_geno(argv):
    """`vargeno-tpu geno ...` in-process; returns its runner. Raises when
    the run left an unresolved capacity overflow."""
    from vargeno_tpu import cli

    runner = cli.geno(cli.build_parser().parse_args(["geno", *argv]))
    ovf = unresolved_overflows(runner)
    if ovf:
        raise RuntimeError(f"unresolved capacity overflows: {ovf}")
    return runner


def unresolved_overflows(runner) -> dict:
    return {k: v for k, v in runner.stats_totals.items()
            if "overflow" in k and v}


# ---------------------------------------------------------------- phases

def phase_device():
    """(a) the default JAX device must be a GPU."""
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"error: the default JAX device is "
                         f"{dev.platform!r}, not a GPU; chip_smoke.py "
                         f"runs on NVIDIA GPUs only")
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)}")
    log(f"card: {card_label()}")
    from vargeno_tpu import native

    log("host encoder: " + (f"native ({native.lib_path()})"
                            if native.available() else "numpy"))
    return dev


def phase_golden(work: str, mesh: int = 0) -> None:
    """(b) index / geno / filt / cohort on the mini fixture through the CLI,
    byte-compared with the reference binary's outputs. ``mesh`` > 0 runs
    geno on reads.fq data-parallel and sharded-dict over that many
    devices instead (no filt or cohort)."""
    work = _fresh(work)
    fx = lambda name: os.path.join(FIX, name)
    idx = os.path.join(work, "idx")
    _cli(["index", fx("genome.fa"), fx("snps.vcf"), idx,
          "--reference-format"])
    for name in ("ref.dict", "snp.dict"):
        if not same_bytes(f"{idx}.{name}", fx(f"golden.{name}")):
            raise AssertionError(f"index: {name} differs from golden")
    log("golden: index .ref.dict/.snp.dict byte-equal")
    for name in ("ref.bf", "ref.bf.lite.bf", "snp.bf"):   # 3.6 GB, unused
        os.remove(f"{idx}.{name}")

    # mesh runs keep the default capacities (--no-auto-tune): one compile
    # per mode, and output must not depend on capacities anyway
    m = ["--mesh", str(mesh), "--no-auto-tune"]
    modes = [[]] if not mesh else [m, m + ["--sharded-dict"]]
    pairs = (("reads.fq", "golden_output.vcf"),
             ("reads_long.fq", "golden_long_output.vcf"))
    for extra in modes:
        tag = " ".join(extra) or "1 card"
        for fq, golden in pairs[:1] if mesh else pairs:
            out = os.path.join(work, f"out_{len(extra)}_{fq}.vcf")
            _cli_geno([idx, fx(fq), fx("snps.vcf"), out,
                       "--batch-reads", "4096", *extra])
            if not same_bytes(out, fx(golden)):
                raise AssertionError(f"geno {fq} ({tag}) differs from "
                                     f"{golden}")
            log(f"golden: geno {fq} ({tag}) byte-equal to {golden}")
    if mesh:
        shutil.rmtree(work)
        return

    fidx = os.path.join(work, "filt")
    _cli(["filt", idx, fidx])
    out = os.path.join(work, "out_filt.vcf")
    _cli_geno([fidx, fx("reads.fq"), fx("snps.vcf"), out,
               "--batch-reads", "4096"])
    if not same_bytes(out, fx("golden_filt_output.vcf")):
        raise AssertionError("filt+geno differs from golden_filt_output")
    log("golden: filt + geno byte-equal to golden_filt_output.vcf")

    _cli(["cohort", idx, fx("snps.vcf"),
          os.path.join(work, "cohort_{sample}.vcf"),
          f"short={fx('reads.fq')}", f"long={fx('reads_long.fq')}",
          "--batch-reads", "4096"])
    for sample, golden in (("short", "golden_output.vcf"),
                           ("long", "golden_long_output.vcf")):
        if not same_bytes(os.path.join(work, f"cohort_{sample}.vcf"),
                          fx(golden)):
            raise AssertionError(f"cohort sample {sample} differs from "
                                 f"{golden}")
    log("golden: cohort (2 samples) byte-equal to golden")
    shutil.rmtree(work)   # several GB of Bloom filters; kept on failure


def real_dataset(work: str, cfg: dict = REAL):
    """Generate (once) the chr22-scale inputs and build their index through
    the CLI. Returns (fasta, vcf, fastq, index prefix)."""
    os.makedirs(work, exist_ok=True)
    marker = os.path.join(work, "ready_" + "_".join(
        str(cfg[k]) for k in sorted(cfg)))
    fa, vcf, fq = (os.path.join(work, n)
                   for n in ("genome.fa", "snps.vcf", "reads.fq"))
    prefix = os.path.join(work, "idx")
    if os.path.exists(marker):
        return fa, vcf, fq, prefix
    from vargeno_tpu.testing import synth_genome, write_inputs

    t0 = time.perf_counter()
    rng = np.random.default_rng(cfg["seed"])
    genome = synth_genome(rng, sizes=(cfg["genome_bp"],), names=("chrB1",))
    write_inputs(work, rng, genome, n_snps=cfg["n_snps"],
                 n_reads=cfg["n_reads"], read_len=cfg["read_len"],
                 err_frac=cfg["err_frac"])
    del genome
    log(f"real: inputs generated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _cli(["index", fa, vcf, prefix])
    log(f"real: cli index (default Bloom geometry) "
        f"{time.perf_counter() - t0:.1f} s")
    open(marker, "w").write("ok")
    return fa, vcf, fq, prefix


@contextlib.contextmanager
def compile_seconds():
    """Yields a one-element list holding the backend compile seconds
    spent inside the block."""
    import jax

    box = [0.0]

    def on_event(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            box[0] += duration

    jax.monitoring.register_event_duration_secs_listener(on_event)
    try:
        yield box
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)


def host_counts(runner):
    """Per-site (ref, alt) counts saturated as the VCF sees them."""
    n = runner.index.sites.pos.shape[0]
    rc, ac = runner._host_counts()
    mc = runner.config.max_cov
    return np.minimum(rc[:n], mc), np.minimum(ac[:n], mc)


def spot_parity(runner, fq: str, n_spot: int, work: str,
                seed: int = 11) -> int:
    """Sample n_spot reads of ``fq``, stream them through ``runner`` (fresh
    accumulators) and through the sequential oracle spec in this process,
    and compare per-site counts exactly. Returns the number of sites
    compared; raises on any mismatch."""
    from vargeno_tpu.oracle import OracleEngine

    with open(fq, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    n_recs = len(lines) // 4
    rng = np.random.default_rng(seed)
    sel = np.sort(rng.choice(n_recs, size=min(n_spot, n_recs),
                             replace=False))
    spot = os.path.join(work, f"spot_{len(sel)}.fq")
    with open(spot, "wb") as f:
        for i in sel:
            f.writelines(lines[4 * i:4 * i + 4])
    del lines

    runner.ref_cnt, runner.alt_cnt = runner._fresh_counts()
    runner.stats_totals = {}
    runner.consume_fastq(spot)
    ovf = unresolved_overflows(runner)
    if ovf:
        raise RuntimeError(f"spot run: unresolved overflows {ovf}")
    rc_e, ac_e = host_counts(runner)

    eng = OracleEngine(runner.index)
    eng.run_fastq(spot)
    pos = runner.index.sites.pos
    rc_o = np.array([eng.pileup[int(p)][4] for p in pos], np.int64)
    ac_o = np.array([eng.pileup[int(p)][5] for p in pos], np.int64)
    bad = np.flatnonzero((rc_e != rc_o) | (ac_e != ac_o))
    if bad.size:
        raise AssertionError(
            f"oracle spot parity: {bad.size} of {pos.shape[0]} sites "
            f"differ; first (pos, eng ref, oracle ref, eng alt, oracle "
            f"alt): {[(int(pos[i]), int(rc_e[i]), int(rc_o[i]), int(ac_e[i]), int(ac_o[i])) for i in bad[:5]]}")
    return pos.shape[0]


def phase_real(work: str, card: str, spot: bool = True):
    """(c) the chr22-scale deployment through `cli index` and `cli geno`
    (default flags, --batch-reads 32768), zero unresolved overflows, and
    (``spot``) oracle spot parity on sampled reads through the same
    runner. Returns (runner host counts, output VCF path)."""
    import jax

    fa, vcf, fq, prefix = real_dataset(os.path.join(work, "data"))
    out = os.path.join(work, "out_1card.vcf")
    t0 = time.perf_counter()
    with compile_seconds() as comp:
        runner = _cli_geno([prefix, fq, vcf, out,
                            "--batch-reads", str(REAL["batch"])])
    wall = time.perf_counter() - t0
    n, n_retry = runner.n_reads, runner.n_retry_reads
    counts = host_counts(runner)

    # warm pass over the same reads with the same (tuned, compiled) runner
    runner.ref_cnt, runner.alt_cnt = runner._fresh_counts()
    t0 = time.perf_counter()
    runner.consume_fastq(fq)
    jax.block_until_ready(runner.ref_cnt)
    warm = time.perf_counter() - t0
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[{card}] real: cli geno {n} reads, wall {wall:.2f} s, "
        f"backend compile {comp[0]:.2f} s, retry reads {n_retry}")
    log(f"[{card}] real: warm pass {REAL['n_reads'] / warm:.0f} reads/s "
        f"({warm:.3f} s), peak_bytes_in_use {peak}")
    log("real: zero unresolved overflow counters")

    if spot:
        t0 = time.perf_counter()
        n_sites = spot_parity(runner, fq, SPOT_READS, work)
        log(f"real: oracle spot parity on {SPOT_READS} reads: 0 "
            f"mismatches over {n_sites} sites "
            f"({time.perf_counter() - t0:.1f} s)")
    del runner
    gc.collect()
    jax.clear_caches()
    return counts, out


def phase_kernels() -> None:
    """(d) the engine's device primitives compiled for the card at real
    widths, each against a plain numpy reference."""
    import jax
    import jax.numpy as jnp

    from vargeno_tpu.engine.batch import vote_scan
    from vargeno_tpu.engine.scan_ops import compact_src, cumsum_mask
    from vargeno_tpu.testing import vote_reference

    rng = np.random.default_rng(3)
    for n in (131_072, 3_178_496):
        for x in (rng.random(n) < 0.5,
                  rng.integers(0, 11, n).astype(np.int32)):
            got = np.asarray(jax.jit(cumsum_mask)(jnp.asarray(x)))
            if not np.array_equal(got, np.cumsum(x, dtype=np.int64)):
                raise AssertionError(f"cumsum_mask differs at {n} lanes "
                                     f"({x.dtype})")
    log("kernels: cumsum_mask exact vs np.cumsum at 131,072 and "
        "3,178,496 lanes")

    for m, n_out, dens in ((300_000, 65_536, 0.1),
                           (3_178_496, 131_072, 0.05)):
        mask = rng.random(m) < dens
        want = np.flatnonzero(mask)[:n_out]
        src, ovf = jax.jit(compact_src, static_argnums=1)(
            jnp.asarray(mask), n_out)
        src = np.asarray(src)
        if not (np.array_equal(src[:want.size], want)
                and (src[want.size:] == -1).all()
                and int(ovf) == max(int(mask.sum()) - n_out, 0)):
            raise AssertionError(f"compact_src wrong at {m} lanes")
    log("kernels: compact_src exact at 300,000 and 3,178,496 lanes")

    E, B, C = 16, 32768, 32
    idx = rng.integers(0, 24, (E, B)).astype(np.uint32)
    k = rng.integers(0, 3, (E, B)).astype(np.int32)
    isnb = rng.random((E, B)) < 0.3
    val = rng.random((E, B)) < 0.5
    for c in (C, 4):   # the engine's width, and one that overflows
        P, T, O = vote_reference(idx, k, isnb, val, c)
        p, t, o = jax.jit(vote_scan, static_argnums=4)(
            jnp.asarray(idx), jnp.asarray(k), jnp.asarray(isnb),
            jnp.asarray(val), c)
        p, t = np.asarray(p), np.asarray(t)
        if not (np.array_equal(p, P) and np.array_equal(t[P], T[P])
                and int(o) == O):
            raise AssertionError(f"vote_scan differs from the sequential "
                                 f"reference at B={B}, E={E}, C={c}")
    log(f"kernels: vote_scan equal to the sequential reference at "
        f"B={B}, E={E}, C={C} and C=4 (overflowing)")


def phase_four(work: str, card: str) -> None:
    """(e) geno over a 4-device mesh, data-parallel and sharded-dict, on
    the chr22-scale data: counts and VCF identical to the 1-card run (at
    default flags, auto-tuned); and both mesh modes byte-equal to golden
    on the mini fixture. The mesh runs keep the default capacities
    (--no-auto-tune), so each mesh step compiles once."""
    import jax

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 devices, found "
                           f"{len(jax.devices())}")
    phase_golden(os.path.join(work, "mini4"), mesh=4)
    ref_counts, ref_vcf = phase_real(os.path.join(work, "real"), card,
                                     spot=False)
    fa, vcf, fq, prefix = real_dataset(os.path.join(work, "real", "data"))
    mesh = ["--mesh", "4", "--no-auto-tune"]
    for extra in (mesh, mesh + ["--sharded-dict"]):
        tag = " ".join(extra)
        out = os.path.join(work, f"out_{len(extra)}.vcf")
        t0 = time.perf_counter()
        with compile_seconds() as comp:
            runner = _cli_geno([prefix, fq, vcf, out, "--batch-reads",
                                str(REAL["batch"]), *extra])
        wall = time.perf_counter() - t0
        counts = host_counts(runner)
        log(f"[{card}] four: geno {tag}: {runner.n_reads} reads, wall "
            f"{wall:.2f} s, backend compile {comp[0]:.2f} s")
        del runner
        gc.collect()
        jax.clear_caches()
        for name, a, b in (("ref", counts[0], ref_counts[0]),
                           ("alt", counts[1], ref_counts[1])):
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"geno {tag}: {name} counts differ from the 1-card "
                    f"run at {int(np.sum(a != b))} sites")
        if not same_bytes(out, ref_vcf):
            raise AssertionError(f"geno {tag}: VCF differs from the "
                                 f"1-card run")
        log(f"four: geno {tag}: counts and VCF identical to 1 card")


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh phase and its "
                         "comparisons (needs 4 GPUs)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "vargeno_tpu")) or \
            not os.path.isdir(FIX):
        print("error: chip_smoke.py must run from a checkout of the "
              "repository (vargeno_tpu/ and tests/fixtures/ not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    dev = phase_device()
    card = card_label()

    phases = ([("four", lambda: phase_four(os.path.join(WORK, "four"),
                                           card))]
              if args.four else
              [("golden", lambda: phase_golden(os.path.join(WORK, "mini"))),
               ("kernels", phase_kernels),
               ("real", lambda: phase_real(os.path.join(WORK, "real"),
                                           card))])
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            log(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)")
            failed.append(name)
    if failed:
        print(f"error: failed phases: {failed}", file=sys.stderr)
        return 1
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
