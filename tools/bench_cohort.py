#!/usr/bin/env python3
"""8-donor cohort throughput on the real chip (BASELINE cohort config).

Streams the bench workload through one CohortRunner as 8 donors (one
index + one compiled step shared across all samples), and
reports cohort reads/s plus the derived donors/hour at a given per-donor
read budget (default: a 6X human WGS donor ~ 120M reads, the reference
paper's NA12878 6X configuration, experiment/experiment.md).

Usage: python tools/bench_cohort.py [--donors 8]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE = os.environ.get("VGT_CACHE", "/tmp/vgt_bench48")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--donors", type=int, default=8)
    ap.add_argument("--wgs-reads-per-donor", type=float, default=120e6,
                    help="read count used to convert to donors/hour")
    args = ap.parse_args()

    import numpy as np

    from vargeno_tpu.config import GenoConfig
    from vargeno_tpu.engine.cohort import CohortRunner
    from vargeno_tpu.index import store

    # every donor streams the FULL bench FASTQ (262K reads): per-donor
    # drain/pipeline-fill overheads amortize like a real WGS donor's
    # thousands of batches would; a 32K-read-per-donor split measures only
    # those fixed overheads (~0.3 s/donor) instead of the cohort rate
    fq = os.path.join(CACHE, "reads.fq")
    paths = [fq] * args.donors

    index = store.load(os.path.join(CACHE, "bench"))
    cfg = GenoConfig(batch_reads=32768, max_read_len=128,
                     max_kmers_per_read=3,
                     auto_tune=True, tune_batches=2)
    names = [f"d{i}" for i in range(args.donors)]
    cohort = CohortRunner(index, names, cfg)
    # warm + tune on donor 0, then reset its counts for the timed run
    cohort.consume_sample(names[0], paths[0], limit_batches=4)
    cohort.counts[names[0]] = None
    cohort.stats[names[0]] = {}
    r = cohort._runner
    r.n_reads = 0

    t0 = time.time()
    for name, p in zip(names, paths):
        cohort.consume_sample(name, p)
    np.asarray(r.ref_cnt)[:1]
    dt = time.time() - t0
    rate = r.n_reads / dt
    donors_per_hour = rate * 3600 / args.wgs_reads_per_donor
    print(json.dumps({
        "metric": "cohort_throughput",
        "donors": args.donors,
        "total_reads": r.n_reads,
        "seconds": round(dt, 2),
        "reads_per_sec": round(rate, 1),
        "donors_per_hour_at_6x_wgs": round(donors_per_hour, 2),
    }))


if __name__ == "__main__":
    main()
