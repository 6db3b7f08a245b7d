#!/usr/bin/env python3
"""Sweep host-pipeline knobs (group_size x pipeline_depth x pre_encode) on
the real chip and report reads/s for each, plus the VGT_TIMING breakdown of
the best configuration. Run after bench.py's dataset exists
(/tmp/vgt_bench48). One full pass of the 262K-read FASTQ per point.

Usage: python tools/tune_host_pipeline.py [quick]
  quick = only (1,2), (8,2) group/depth points
"""
import itertools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from vargeno_tpu.config import GenoConfig  # noqa: E402
from vargeno_tpu.engine.geno import GenoRunner  # noqa: E402
from vargeno_tpu.index import store  # noqa: E402

FQ = "/tmp/vgt_bench48/reads.fq"


_DIX = [None]


def run_point(index, group, depth, pre_encode=True, passes=2):
    cfg = GenoConfig(batch_reads=32768, max_read_len=128,
                     max_kmers_per_read=4,
                     pre_encode=pre_encode, group_size=group,
                     pipeline_depth=depth, events_per_read=16)
    if _DIX[0] is None:
        from vargeno_tpu.engine.device_index import build_device_index

        _DIX[0] = build_device_index(index)
    runner = GenoRunner(index, cfg, queued_orientation=True, dix=_DIX[0])
    runner.consume_fastq(FQ, limit_batches=2 * max(group, 1))  # compile
    rates = []
    for _ in range(passes):
        t0 = time.time()
        n0 = runner.n_reads
        runner.consume_fastq(FQ)
        jax.block_until_ready(runner.ref_cnt)
        rates.append((runner.n_reads - n0) / (time.time() - t0))
    best = max(rates)
    print(f"group={group} depth={depth} pre={pre_encode}: "
          f"{best:,.0f} reads/s (passes: "
          + ", ".join(f"{r:,.0f}" for r in rates) + ")", flush=True)
    return best


def main():
    quick = len(sys.argv) > 1 and sys.argv[1] == "quick"
    print(f"devices: {jax.devices()}", flush=True)
    index = store.load_npz("/tmp/vgt_bench48/bench")
    points = ([(1, 2), (8, 2)] if quick
              else list(itertools.product((1, 4, 8), (1, 2, 4))))
    results = {}
    results[("codes", 1, 1)] = run_point(index, 1, 1, pre_encode=False)
    for g, d in points:
        results[("enc", g, d)] = run_point(index, g, d)
    best = max(results, key=results.get)
    print(f"\nBEST {best}: {results[best]:,.0f} reads/s")
    print("\nVGT_TIMING breakdown of best point:")
    os.environ["VGT_TIMING"] = "1"
    run_point(index, best[1], best[2], pre_encode=best[0] == "enc",
              passes=1)


if __name__ == "__main__":
    main()
