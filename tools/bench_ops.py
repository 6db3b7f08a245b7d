#!/usr/bin/env python3
"""Device timings of the engine's scan primitives, for choosing between
formulations (engine/scan_ops.py):

  - prefix sum of a 0/1 mask: ``jnp.cumsum`` (an integer scan) against a
    blocked triangular-matmul form in float32 with
    ``precision=HIGHEST`` pinned (exact while the total < 2^24);
  - stream compaction: ``compact_src`` (prefix sum + scatter, "scan")
    against a sort-based form ("sort").

Each candidate runs over R distinct inputs inside one jitted ``lax.map``,
so one dispatch covers R calls; the median of several such runs, divided
by R, is reported. Every result is also checked against numpy.

Usage: python tools/bench_ops.py      (prints one JSON line last)
"""

import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vargeno_tpu.engine.scan_ops import compact_src  # noqa: E402

R = 8       # inputs per dispatch
REPS = 7    # timed dispatches (median)


@functools.lru_cache(maxsize=None)
def _tri(n: int):
    i = np.arange(n)
    return (i[:, None] <= i[None, :]).astype(np.float32)


def cumsum_matmul(x, C: int = 128):
    """Inclusive prefix sum by recursive blocked triangular matmuls in
    float32, full precision pinned."""
    mm = functools.partial(jnp.matmul, precision=lax.Precision.HIGHEST)
    n = x.shape[0]
    if n <= C:
        return mm(x[None, :], _tri(max(n, 1)))[0]
    rows = -(-n // C)
    xp = jnp.pad(x, (0, rows * C - n)).reshape(rows, C)
    within = mm(xp, _tri(C))
    totals = within[:, -1]
    base = cumsum_matmul(totals, C) - totals
    return (within + base[:, None]).reshape(-1)[:n]


def compact_sort(mask, n_out: int):
    """compact_src by sort: key = lane_id | (miss << 31); one u32 device
    sort brings every set lane to the front in order."""
    (m,) = mask.shape
    key = jnp.arange(m, dtype=jnp.uint32) | jnp.where(
        mask, jnp.uint32(0), jnp.uint32(0x80000000))
    if n_out > m:
        key = jnp.concatenate(
            [key, jnp.full(n_out - m, 0xFFFFFFFF, jnp.uint32)])
    skey = lax.sort(key, is_stable=False)[:n_out]
    ok = skey < jnp.uint32(0x80000000)
    src = jnp.where(ok, skey.astype(jnp.int32), -1)
    return src, jnp.sum(mask, dtype=jnp.int32) - jnp.sum(ok, dtype=jnp.int32)


def timed(fn, xs):
    """Median seconds per call of fn over the stacked inputs xs (R, ...)."""
    run = jax.jit(lambda a: lax.map(fn, a))
    out = jax.block_until_ready(run(xs))   # compile + warm
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(run(xs))
        ts.append((time.perf_counter() - t0) / R)
    return sorted(ts)[len(ts) // 2], out


def main():
    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    res = {"device": dev.device_kind, "platform": dev.platform}

    for n in (131_072, 3_178_496):
        masks = rng.random((R, n)) < 0.5
        want = np.cumsum(masks, axis=1, dtype=np.int64)
        xs = jnp.asarray(masks)
        for name, fn in (
                ("cumsum", lambda m: jnp.cumsum(m.astype(jnp.int32))),
                ("matmul_highest", lambda m: cumsum_matmul(
                    m.astype(jnp.float32)).astype(jnp.int32))):
            t, out = timed(fn, xs)
            exact = bool(np.array_equal(np.asarray(out), want))
            res[f"prefix_{name}_{n}_us"] = t * 1e6
            res[f"prefix_{name}_{n}_exact"] = exact
            print(f"prefix sum {name:15s} {n:9d} lanes: {t * 1e6:9.1f} us"
                  f"  exact={exact}", file=sys.stderr)

    for m, n_out, dens in ((300_000, 65_536, 0.1),
                           (3_178_496, 131_072, 0.05)):
        masks = rng.random((R, m)) < dens
        xs = jnp.asarray(masks)
        for method, fn in (("sort", compact_sort), ("scan", compact_src)):
            t, (src, ovf) = timed(lambda a: fn(a, n_out), xs)
            src = np.asarray(src)
            ok = all(np.array_equal(src[r][:min(n_out, masks[r].sum())],
                                    np.flatnonzero(masks[r])[:n_out])
                     for r in range(R))
            res[f"compact_{method}_{m}_us"] = t * 1e6
            res[f"compact_{method}_{m}_exact"] = ok
            print(f"compact_src {method:4s} {m:9d} lanes -> {n_out}: "
                  f"{t * 1e6:9.1f} us  exact={ok}", file=sys.stderr)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
