#!/usr/bin/env python3
"""Timed end-to-end bench stages (setup + throughput) on the real chip."""
import time, sys, os
T0 = time.time()
def log(m): print(f"[{time.time()-T0:7.1f}s] {m}", flush=True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
from vargeno_tpu.config import GenoConfig
from vargeno_tpu.index import store
from vargeno_tpu.engine.geno import GenoRunner
log("loading npz")
index = store.load_npz("/tmp/vgt_bench48/bench")
log("npz loaded; GenoRunner init")
cfg = GenoConfig(batch_reads=32768, max_read_len=128, max_kmers_per_read=4)
runner = GenoRunner(index, cfg, queued_orientation=True)
log("runner ready; warm/compile 2 batches")
runner.consume_fastq("/tmp/vgt_bench48/reads.fq", limit_batches=2)
log("warm")
t0 = time.time(); n0 = runner.n_reads
runner.consume_fastq("/tmp/vgt_bench48/reads.fq")
jax.block_until_ready(runner.ref_cnt)
dt = time.time() - t0
log(f"rate: {(runner.n_reads-n0)/dt:.0f} reads/s")
