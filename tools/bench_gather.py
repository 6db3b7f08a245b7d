#!/usr/bin/env python3
"""Microbenchmark: random-access primitive rates on the current device.

The geno inner loop is gather-dominated (hash-bucket rows, scan windows,
event scatters). This tool measures, on the device JAX finds:

  - XLA gather of 4 B words from a large table
  - XLA gather of 128 B and 512 B rows (bucket-row-shaped)
  - XLA scatter of 20 B rows and of scalar words (event-buffer-shaped)
  - the device sort rate (the compaction primitive)

Rates (lanes/sec) feed the lane roofline in utils/roofline.py; without a
measurement the roofline reports its lane terms as not measured.

Usage: python tools/bench_gather.py   (prints one JSON line)
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def log(*a):
    print(*a, file=sys.stderr)


def timed(fn, *args, chain=32):
    """Per-call device time over a DEPENDENT chain: fn takes a trailing
    uint32 scalar `acc` (dependency token) and returns a scalar, so chained
    calls serialize on the device; one block_until_ready ends the chain."""
    acc = jax.block_until_ready(fn(*args, jnp.uint32(0)))  # compile
    t0 = time.perf_counter()
    for _ in range(chain):
        acc = fn(*args, acc)
    jax.block_until_ready(acc)
    return (time.perf_counter() - t0) / chain, acc


def measure() -> dict:
    """Lane rates (lanes/sec) keyed as utils.roofline.device_lane_rates
    expects, plus the device kind."""
    dev = jax.devices()[0]
    log(f"# device: {dev.device_kind}")
    rng = np.random.default_rng(7)
    out = {"device": dev.device_kind}

    MB = 256
    table_w = jnp.asarray(rng.integers(0, 2**32, MB * 2**20 // 4,
                                       dtype=np.uint32))
    n_rows = MB * 2**20 // 128
    table_r = jnp.asarray(
        rng.integers(0, 2**32, (n_rows, 32), dtype=np.uint32))

    for N in (1 << 20, 1 << 21):
        idx_w = jnp.asarray(rng.integers(0, table_w.shape[0], N,
                                         dtype=np.int32))
        idx_r = jnp.asarray(rng.integers(0, n_rows, N, dtype=np.int32))
        # per-lane salts make the reduction non-decomposable: XLA cannot
        # legally rewrite sum_i(T[idx_i] ^ s_i) into a histogram @ table
        # pass (without them, large-N "gather" rates exceed HBM peak)
        salt_w = jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint32))
        salt_r = jnp.asarray(rng.integers(0, 2**32, (N, 32),
                                          dtype=np.uint32))

        @jax.jit
        def g_word(t, i, s, acc):
            # optimization_barrier: real data dependency on the previous
            # call's result, so chained calls serialize on device
            i2, acc2 = jax.lax.optimization_barrier((i, acc))
            return jnp.sum(jnp.take(t, i2, axis=0, mode="clip") ^ s,
                           dtype=jnp.uint32) ^ acc2

        @jax.jit
        def g_row(t, i, s, acc):
            i2, acc2 = jax.lax.optimization_barrier((i, acc))
            return jnp.sum(jnp.take(t, i2, axis=0, mode="clip") ^ s,
                           dtype=jnp.uint32) ^ acc2

        tw, _ = timed(g_word, table_w, idx_w, salt_w)
        tr, _ = timed(g_row, table_r, idx_r, salt_r)
        # sorted-index variants: if these run much faster, random probes
        # should be SORTED first (quasi-sequential HBM access), i.e. a
        # sort-merge join beats point lookups
        tws, _ = timed(g_word, table_w, jnp.sort(idx_w), salt_w)
        trs, _ = timed(g_row, table_r, jnp.sort(idx_r), salt_r)
        log(f"N={N:8d}  word-gather {N/tw/1e6:8.1f} Mlanes/s "
              f"({N*4/tw/1e9:6.2f} GB/s)  sorted {N/tws/1e6:8.1f}   "
              f"row-gather {N/tr/1e6:8.1f} Mlanes/s "
              f"({N*128/tr/1e9:6.2f} GB/s)  sorted {N/trs/1e6:8.1f}")
        out[f"word_gather_{N}"] = N / tw
        out[f"row_gather_{N}"] = N / tr
        out[f"word_gather_sorted_{N}"] = N / tws
        out[f"row_gather_sorted_{N}"] = N / trs

    # full-width rows (128 u32 = 512 B -- the combined hash table's
    # bucket row; tools/bench_rowwidth.py has the full width sweep); feeds
    # roofline's row512 rate
    n_rows5 = MB * 2**20 // 512
    table_r5 = jnp.asarray(
        rng.integers(0, 2**32, (n_rows5, 128), dtype=np.uint32))
    N5 = 1 << 19
    idx_r5 = jnp.asarray(rng.integers(0, n_rows5, N5, dtype=np.int32))
    salt_r5 = jnp.asarray(rng.integers(0, 2**32, (N5, 128),
                                       dtype=np.uint32))

    @jax.jit
    def g_row5(t, i, s, acc):
        i2, acc2 = jax.lax.optimization_barrier((i, acc))
        return jnp.sum(jnp.take(t, i2, axis=0, mode="clip") ^ s,
                       dtype=jnp.uint32) ^ acc2

    tr5, _ = timed(g_row5, table_r5, idx_r5, salt_r5)
    log(f"row-gather 512B {N5/tr5/1e6:8.1f} Mlanes/s "
          f"({N5*512/tr5/1e9:6.2f} GB/s)")
    out["row_gather_512B"] = N5 / tr5
    del table_r5, salt_r5

    # shaped-index penalty: the SAME row gather issued with (B, K)-shaped
    # indices (engine.hashtable flattens every lookup; this measures
    # whether that still matters)
    N = 1 << 20
    idx2d = jnp.asarray(rng.integers(0, n_rows, (N // 4, 4),
                                     dtype=np.int32))
    salt2d = jnp.asarray(rng.integers(0, 2**32, (N // 4, 4, 32),
                                      dtype=np.uint32))

    @jax.jit
    def g_row2d(t, i, s, acc):
        i2, acc2 = jax.lax.optimization_barrier((i, acc))
        return jnp.sum(jnp.take(t, i2, axis=0, mode="clip") ^ s,
                       dtype=jnp.uint32) ^ acc2

    t2d, _ = timed(g_row2d, table_r, idx2d, salt2d)
    log(f"row-gather shaped (B,4) {N/t2d/1e6:8.1f} Mlanes/s")
    out["row_gather_shaped_1048576"] = N / t2d

    # device-side sort rate (the enabler for sort-merge designs)
    N = 1 << 21
    keys = jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint32))

    @jax.jit
    def dsort(k, acc):
        k2, acc2 = jax.lax.optimization_barrier((k, acc))
        s = jnp.sort(k2)
        return (s[0] + s[-1]) ^ acc2

    tso, _ = timed(dsort, keys)
    log(f"device-sort u32 {N/tso/1e6:8.1f} Mkeys/s")
    out["device_sort_u32"] = N / tso

    # scatter of 20 B rows into a (B, E, 5) u32 buffer (event-shaped)
    B, E = 32768, 16
    N = B * 4
    rows_b = jnp.asarray(rng.integers(0, B, N, dtype=np.int32))
    rows_e = jnp.asarray(rng.integers(0, E, N, dtype=np.int32))
    vals = jnp.asarray(rng.integers(0, 2**32, (N, 5), dtype=np.uint32))

    @jax.jit
    def scat(rb, re, v, acc):
        rb2, acc2 = jax.lax.optimization_barrier((rb, acc))
        buf = jnp.zeros((B, E + 1, 5), jnp.uint32)
        return buf.at[rb2, re].set(v, mode="drop").sum(
            dtype=jnp.uint32) ^ acc2

    ts, _ = timed(scat, rows_b, rows_e, vals)
    log(f"scatter-20B {N/ts/1e6:8.1f} Mlanes/s")
    out["scatter_rows"] = N / ts

    # SCALAR-element scatter into a flat word buffer (the engine's event
    # writes)
    flat_t = jnp.asarray(rng.integers(0, B * (E + 1), N, dtype=np.int32))

    @jax.jit
    def scat1(ft, v, acc):
        ft2, acc2 = jax.lax.optimization_barrier((ft, acc))
        buf = jnp.zeros(B * (E + 1), jnp.uint32)
        return buf.at[ft2].set(v[:, 0], mode="drop").sum(
            dtype=jnp.uint32) ^ acc2

    ts1, _ = timed(scat1, flat_t, vals)
    log(f"scatter-scalar {N/ts1/1e6:8.1f} Mlanes/s")
    out["scatter_scalar"] = N / ts1

    return out


def main():
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
