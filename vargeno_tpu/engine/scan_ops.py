"""Prefix sums and stream compaction for the engine's compaction passes.

Every stream-compaction in the batched pipeline (low-quality k-mer items,
probe hits, ambiguous exact hits, agreeing contexts, site hits) needs an
exclusive prefix sum of a 0/1 (or small-int) mask over 10^5..10^7 lanes.
Both are left to XLA. On the H100, ``jnp.cumsum`` beat a float32
triangular-matmul prefix sum at 3.2M lanes, and prefix-sum + scatter
compaction beat a sort-based one about 2x at 0.3M and 3.2M lanes
(``tools/bench_ops.py`` keeps both candidates and times them; PERF.md).
"""

from __future__ import annotations

import jax.numpy as jnp


def cumsum_mask(x, dtype=jnp.int32):
    """Inclusive prefix sum of a flat non-negative small-int/bool array in
    ``dtype`` (an integer scan: exact at any length)."""
    return jnp.cumsum(x.astype(dtype))


def compact_src(mask, n_out: int):
    """Stream-compaction index map: ``mask`` (M,) bool -> ``src`` (n_out,)
    int32 where src[j] = index of the j-th set lane (in ascending lane
    order), -1 for empty slots; plus the count of set lanes that did not
    fit (``overflow``).

    This is THE engine compaction primitive (low-quality items, probe
    hits, ambiguous exact hits, sparse events, agreeing contexts, site
    hits, active probe lanes): exclusive-prefix-sum targets + one scatter
    of the lane iota.
    """
    (m,) = mask.shape
    assert m < (1 << 31), "compact_src: lane id must fit in 31 bits"
    total = jnp.sum(mask, dtype=jnp.int32)
    tgt = cumsum_mask(mask) - 1
    keep = mask & (tgt < n_out)
    src = jnp.full(n_out, -1, jnp.int32).at[
        jnp.where(keep, tgt, n_out)].set(
            jnp.arange(m, dtype=jnp.int32), mode="drop",
            unique_indices=True)
    kept = jnp.sum(keep, dtype=jnp.int32)
    return src, total - kept
