#!/usr/bin/env python3
"""Device time of the steady geno step and the vote stage's share of it.

Builds the runner the CLI would build for the chr22-scale smoke dataset
(`python chip_smoke.py` generates it under build/smoke/real/data) and
streams the FASTQ once so auto-tune settles the capacities; then:

  - end to end: two warm passes over the whole FASTQ (reads/s);
  - per step, on resident pre-encoded batches of the tuned step: wall time
    with and without the vote stage (``_ablate="no_vote"``), and a
    jax.profiler trace, with device kernel time attributed to the ``vote``
    named scope through the compiled module's op metadata.

Usage: python tools/trace_step.py [--data DIR] [--out DIR]
Prints one JSON line last; the trace and a per-op table go to --out.
"""

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SETS = 4


def step_seconds(fn, sets, reps=5):
    jax.block_until_ready([fn(*s) for s in sets])   # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready([fn(*s) for s in sets])
        ts.append((time.perf_counter() - t0) / len(sets))
    return sorted(ts)[len(ts) // 2]


def scope_of_ops(hlo_text: str, scope: str) -> set:
    """Instruction names of the compiled module whose op_name metadata
    lies inside the named scope."""
    pat = re.compile(r"%?([\w.\-]+) = .*op_name=\"([^\"]*)\"")
    return {m.group(1) for m in map(pat.search, hlo_text.splitlines())
            if m and f"/{scope}/" in m.group(2) + "/"}


def device_events(xplane: str, plane_prefix: str = "/device:GPU:0"):
    """(name, hlo_op, start_ns, dur_ns) of every event on the device."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane)
    out = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for e in line.events:
                stats = dict(e.stats)
                out.append((e.name, str(stats.get("hlo_op", "")),
                            e.start_ns, e.duration_ns))
    return out


def busy_ns(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, -1.0
    for _, _, s, d in sorted(events, key=lambda e: e[2]):
        if s + d <= end:
            continue
        total += s + d - max(s, end)
        end = s + d
    return total


def vote_share(proc, dix, sets, zeros, out_dir):
    """Trace one pass over the resident sets; device time per step and
    the part of it inside the ``vote`` scope."""
    hlo = jax.jit(proc.raw_single_enc).lower(
        dix, *sets[0], *zeros).compile().as_text()
    vote_ops = scope_of_ops(hlo, "vote")
    os.makedirs(out_dir, exist_ok=True)
    jax.profiler.start_trace(out_dir)
    jax.block_until_ready([proc.single_enc(*s, *zeros) for s in sets])
    jax.profiler.stop_trace()
    xplane = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                              recursive=True))[-1]
    plat = jax.devices()[0].platform
    evs = device_events(xplane, "/device:GPU:0" if plat == "gpu"
                        else "/host:CPU")
    kernel_ns = sum(e[3] for e in evs)
    vote_ns = sum(e[3] for e in evs if e[1] in vote_ops)
    per_op = collections.Counter()
    for name, op, _, d in evs:
        per_op[(op or name)[:80], op in vote_ops] += d
    with open(os.path.join(out_dir, "ops.tsv"), "w") as f:
        for (op, is_vote), d in per_op.most_common(200):
            f.write(f"{d / 1e6 / len(sets):.4f}\t{int(is_vote)}\t{op}\n")
    n = len(sets)
    return dict(n_device_events=len(evs), n_vote_ops=len(vote_ops),
                device_busy_ms_per_step=busy_ns(evs) / 1e6 / n,
                kernel_ms_per_step=kernel_ns / 1e6 / n,
                vote_kernel_ms_per_step=vote_ns / 1e6 / n,
                vote_share=(vote_ns / kernel_ns) if kernel_ns else None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=os.path.join(REPO, "build", "smoke",
                                                   "real", "data"))
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "trace_step"))
    args = ap.parse_args()

    from vargeno_tpu import cli, native
    from vargeno_tpu.engine.batch import make_batch_processor
    from vargeno_tpu.engine.geno import GenoRunner
    from vargeno_tpu.index import store
    from vargeno_tpu.io.fastq import iter_read_batches

    fq = os.path.join(args.data, "reads.fq")
    gargs = cli.build_parser().parse_args(
        ["geno", os.path.join(args.data, "idx"), fq, "-", "-",
         "--batch-reads", "32768"])
    runner = GenoRunner(store.load(gargs.prefix),
                        cli._config(gargs, fastqs=(fq,)))
    runner.consume_fastq(fq)            # auto-tune settles the caps
    cfg = runner._cfg_run
    res = {"device": jax.devices()[0].device_kind,
           "tuned": dict(B=cfg.batch_reads, E=cfg.events_per_read,
                         C=cfg.candidates_per_read)}
    for i in range(2):
        runner.ref_cnt, runner.alt_cnt = runner._fresh_counts()
        n0 = runner.n_reads
        t0 = time.perf_counter()
        runner.consume_fastq(fq)
        jax.block_until_ready(runner.ref_cnt)
        res[f"e2e_reads_per_s_{i}"] = ((runner.n_reads - n0)
                                       / (time.perf_counter() - t0))

    K = cfg.max_kmers_per_read
    sets = []
    for i, b in enumerate(iter_read_batches(fq, cfg.batch_reads,
                                            cfg.max_read_len, K)):
        if i >= N_SETS:
            break
        enc = native.encode_batch(b.codes, b.n_kmers, K)
        sets.append(tuple(jnp.asarray(x) for x in enc)
                    + (jnp.asarray(b.qual),))
    zeros = runner._fresh_counts()
    procs = {"full": runner._proc(cfg),
             "no_vote": make_batch_processor(runner.dix, cfg,
                                             _ablate="no_vote")}
    for name, proc in procs.items():
        res[f"step_ms_{name}"] = 1e3 * step_seconds(
            lambda *s: proc.single_enc(*s, *zeros)[0], sets)
    res["trace"] = vote_share(procs["full"], runner.dix, sets, zeros,
                              args.out)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
