"""Prefix-sum and compaction exactness vs numpy (engine/scan_ops.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from vargeno_tpu.engine.scan_ops import cumsum_mask


@pytest.mark.parametrize("n", [0, 1, 5, 127, 128, 129, 512, 513,
                               4 * 128, 4 * 128 + 1, 100_000, 3_178_496])
def test_cumsum_mask_bool(n):
    rng = np.random.default_rng(n + 1)
    x = rng.random(n) < 0.3
    got = np.asarray(cumsum_mask(jnp.asarray(x)))
    want = np.cumsum(x.astype(np.int32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [200, 40_000])
def test_cumsum_mask_smallint(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 11, n).astype(np.int32)
    got = np.asarray(cumsum_mask(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.cumsum(x))


@pytest.mark.parametrize("m,n,dens", [
    (1, 64, 1.0), (1000, 64, 0.1), (4096, 128, 0.5), (100, 200, 0.9),
    (7, 4, 1.0), (64, 64, 0.0), (300_000, 4096, 0.01)])
def test_compact_src_matches_flatnonzero(m, n, dens):
    """Compaction keeps the set lanes in ascending order, pads with -1 and
    counts the spill."""
    from vargeno_tpu.engine.scan_ops import compact_src

    rng = np.random.default_rng(m + n)
    mask = jnp.asarray(rng.random(m) < dens)
    src, ovf = compact_src(mask, n)
    want = np.flatnonzero(np.asarray(mask))[:n]
    got = np.asarray(src)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got[:want.size], want)
    assert (got[want.size:] == -1).all()
    assert int(ovf) == max(int(np.asarray(mask).sum()) - n, 0)


@pytest.mark.parametrize("shape", [(64,), (512,), (40,), (4, 96), (3, 50)])
def test_pack_host_roundtrip(shape):
    """_pack_host/_unpack_host: one-fetch batch sync is lossless."""
    from vargeno_tpu.engine.geno import _pack_host, _unpack_host

    rng = np.random.default_rng(int(np.prod(shape)))
    stats = rng.integers(-5, 2**31 - 1, 7).astype(np.int32)
    proc = rng.random(shape) < 0.5
    rok = rng.random(shape) < 0.8
    vec = np.asarray(_pack_host(jnp.asarray(stats), jnp.asarray(proc),
                                jnp.asarray(rok)))
    s2, p2, r2 = _unpack_host(vec, 7, shape)
    np.testing.assert_array_equal(s2, stats)
    np.testing.assert_array_equal(p2, proc)
    np.testing.assert_array_equal(r2, rok)
