#!/usr/bin/env python3
"""Row-width sweep for the exact-lookup probe design.

Measures flat-index row-gather rates for bucket-row widths 8..128 u32
(32 B..512 B) from a large table, plus the two-stage alternative (narrow
key-row probe + payload word gathers only on hit), with the dependent-chain
timing of tools/bench_gather.py.

Decides whether narrowing the combined hash-table bucket row
(engine/hashtable.py, currently 32 slots x 16 B = 512 B) raises the exact-
lookup rate -- the reference's analog rows are 9-11 B (vartype.h:64-79).
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_gather import timed  # noqa: E402


def main():
    dev = jax.devices()[0]
    print(f"# device: {dev.device_kind}", file=sys.stderr)
    rng = np.random.default_rng(11)
    out = {"device": dev.device_kind}
    MB = 512
    N = 1 << 20  # probe lanes (the bench step's exact grid is ~100K-1M)

    for W in (8, 16, 32, 64, 128):  # u32 per row: 32 B .. 512 B
        n_rows = MB * 2**20 // (4 * W)
        tab = jnp.asarray(rng.integers(0, 2**32, (n_rows, W),
                                       dtype=np.uint32))
        idx = jnp.asarray(rng.integers(0, n_rows, N, dtype=np.int32))
        salt = jnp.asarray(rng.integers(0, 2**32, (N, W), dtype=np.uint32))

        @jax.jit
        def g_row(t, i, s, acc):
            i2, acc2 = jax.lax.optimization_barrier((i, acc))
            return jnp.sum(jnp.take(t, i2, axis=0, mode="clip") ^ s,
                           dtype=jnp.uint32) ^ acc2

        tr, _ = timed(g_row, tab, idx, salt)
        rate = N / tr
        print(f"row {W*4:4d} B: {rate/1e6:7.1f} M rows/s "
              f"({N*W*4/tr/1e9:6.2f} GB/s)")
        out[f"row{W*4}"] = rate
        del tab, salt

    # two-stage probe shaped like a 16-slot split table: key row (NB, 32)
    # u32 [hi x16 | lo x16] = 128 B probe, then payload = one 8 B row
    # gather from (NB*16, 2) for ~hit_frac of lanes (compacted).  The sum
    # over the key row stands in for the slot-compare math.
    NB = MB * 2**20 // (4 * 32)
    keys = jnp.asarray(rng.integers(0, 2**32, (NB, 32), dtype=np.uint32))
    pay = jnp.asarray(rng.integers(0, 2**32, (NB * 16, 2), dtype=np.uint32))
    idx = jnp.asarray(rng.integers(0, NB, N, dtype=np.int32))
    salt = jnp.asarray(rng.integers(0, 2**32, (N, 32), dtype=np.uint32))
    for hit_frac in (1.0, 0.5):
        M = int(N * hit_frac)
        pidx = jnp.asarray(rng.integers(0, NB * 16, M, dtype=np.int32))
        psalt = jnp.asarray(rng.integers(0, 2**32, (M, 2), dtype=np.uint32))

        @jax.jit
        def two_stage(kt, pt, i, s, pi, ps, acc):
            i2, acc2 = jax.lax.optimization_barrier((i, acc))
            a = jnp.sum(jnp.take(kt, i2, axis=0, mode="clip") ^ s,
                        dtype=jnp.uint32)
            pi2 = jax.lax.optimization_barrier(pi)
            b = jnp.sum(jnp.take(pt, pi2, axis=0, mode="clip") ^ ps,
                        dtype=jnp.uint32)
            return a ^ b ^ acc2

        t2, _ = timed(two_stage, keys, pay, idx, salt, pidx, psalt)
        print(f"two-stage 128B key + 8B payload (hit {hit_frac:.0%}): "
              f"{N/t2/1e6:7.1f} M probes/s")
        out[f"two_stage_hit{int(hit_frac*100)}"] = N / t2

    print(json.dumps(out))


if __name__ == "__main__":
    main()
