"""Hash table, vote scan, filt, and CLI smoke tests."""

import os
import subprocess
import sys

import numpy as np
import pytest

from vargeno_tpu.config import GenoConfig

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "mini")


def test_hashtable_roundtrip():
    from vargeno_tpu.engine.hashtable import build_hash_table, ht_lookup
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    n = 5000
    keys = np.unique(rng.integers(0, 2**63, n, dtype=np.uint64))
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    pos = rng.integers(0, 2**32, keys.size, dtype=np.uint32)
    flag = rng.integers(0, 2, keys.size, dtype=np.uint8)
    info = rng.integers(0, 256, keys.size, dtype=np.uint8)
    tab = build_hash_table(hi, lo, pos, flag, info)

    hit, p, f, i = ht_lookup(jnp.asarray(tab.table), tab.nb, tab.chain,
                             jnp.asarray(hi), jnp.asarray(lo))
    assert bool(np.asarray(hit).all())
    np.testing.assert_array_equal(np.asarray(p), pos)
    np.testing.assert_array_equal(np.asarray(f), flag)
    np.testing.assert_array_equal(np.asarray(i), info)

    # absent keys miss
    absent = rng.integers(0, 2**63, 2000, dtype=np.uint64)
    absent = absent[~np.isin(absent, keys)]
    ah = (absent >> np.uint64(32)).astype(np.uint32)
    al = (absent & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hit2, *_ = ht_lookup(jnp.asarray(tab.table), tab.nb, tab.chain,
                         jnp.asarray(ah), jnp.asarray(al))
    assert not bool(np.asarray(hit2).any())


@pytest.mark.parametrize("E,B,C,n_idx", [
    (32, 256, 16, 20),    # tables never fill
    (16, 512, 4, 40),     # small C: inserts overflow and are counted
    (24, 300, 2, 8),
])
def test_vote_scan_matches_sequential_oracle(E, B, C, n_idx):
    """The engine's vote (engine.batch.vote_scan) vs the per-read
    sequential oracle of improved_index_table_add (qv.cc:132-178)."""
    import jax.numpy as jnp

    from vargeno_tpu.engine.batch import vote_scan
    from vargeno_tpu.testing import vote_reference

    rng = np.random.default_rng(7)
    idx = rng.integers(0, n_idx, (E, B)).astype(np.uint32)
    k = rng.integers(0, 4, (E, B)).astype(np.int32)
    isnb = rng.random((E, B)) < 0.3
    val = rng.random((E, B)) < 0.6
    process, target, ovf = vote_scan(jnp.asarray(idx), jnp.asarray(k),
                                     jnp.asarray(isnb), jnp.asarray(val), C)
    P, T, O = vote_reference(idx, k, isnb, val, C)
    assert P.any()
    np.testing.assert_array_equal(np.asarray(process), P)
    np.testing.assert_array_equal(np.asarray(target)[P], T[P])
    assert int(ovf) == O
    assert (O > 0) == (C < 8)


def test_filt(mini_index, tmp_path):
    from vargeno_tpu.index.filt import filt_ref_dict

    new = filt_ref_dict(mini_index.ref, mini_index.snp_locations)
    # keeps every ambiguous row and everything near a SNP; strictly smaller
    assert 0 < new.kmers.shape[0] < mini_index.ref.kmers.shape[0]
    kept = set(new.kmers.tolist())
    amb = mini_index.ref.kmers[mini_index.ref.flag == 1]
    assert all(k in kept for k in amb.tolist())


def test_cli_help():
    out = subprocess.run(
        [sys.executable, "-m", "vargeno_tpu.cli", "--help"],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0
    for cmd in ("index", "geno", "vcfbf", "ucscd", "ucscbf", "filt"):
        assert cmd in out.stdout


def test_store_dir_roundtrip(mini_index, tmp_path):
    import numpy as np

    from vargeno_tpu.index import store

    prefix = str(tmp_path / "idx")
    store.save(prefix, mini_index)
    assert store.exists(prefix)
    got = store.load(prefix)  # mmap path
    np.testing.assert_array_equal(np.asarray(got.ref.kmers),
                                  mini_index.ref.kmers)
    np.testing.assert_array_equal(np.asarray(got.snp.pos),
                                  mini_index.snp.pos)
    np.testing.assert_array_equal(np.asarray(got.ref_bf.words),
                                  mini_index.ref_bf.words)
    np.testing.assert_array_equal(np.asarray(got.sites.pos),
                                  mini_index.sites.pos)
    assert got.chrlens == mini_index.chrlens
    assert got.ref_bf.bits == mini_index.ref_bf.bits
    # the mmap'd index must drive the engine identically: device index
    # build accepts read-only arrays
    from vargeno_tpu.engine.device_index import build_device_index

    dix = build_device_index(got)
    assert dix.n_ref == mini_index.ref.kmers.shape[0]


def test_derived_table_cache_roundtrip(mini_index, tmp_path):
    import numpy as np

    from vargeno_tpu.engine.device_index import build_device_index
    from vargeno_tpu.index import store

    prefix = str(tmp_path / "dix_cache")
    store.save_dir(prefix, mini_index)
    a = build_device_index(store.load(prefix))   # builds + saves cache
    import os

    assert os.path.exists(prefix + ".vgt/derived/meta.json")
    b = build_device_index(store.load(prefix))   # mmap-loads cache
    for f in ("both_ht", "both_pf", "ref_jg", "snp_jg"):
        assert (np.asarray(getattr(a, f)) == np.asarray(getattr(b, f))).all()
    assert (a.both_ht_nb, a.both_ht_chain, a.ref_win_rows) == \
        (b.both_ht_nb, b.both_ht_chain, b.ref_win_rows)
    store.save_dir(prefix, mini_index)           # rebuild wipes the cache
    assert not os.path.isdir(prefix + ".vgt/derived")


def test_prefetch_shutdown_and_propagation():
    """prefetch() must not leak worker threads when the consumer stops
    early, must deliver all items on full consumption, and must
    repropagate producer exceptions (vargeno_tpu/io/fastq.py)."""
    import threading
    import time

    from vargeno_tpu.io.fastq import prefetch

    before = set(threading.enumerate())
    g = prefetch(iter(range(1000)), depth=2)
    assert next(g) == 0
    g.close()                      # abandoned mid-stream
    deadline = time.time() + 5.0
    while time.time() < deadline:
        if set(threading.enumerate()) <= before:
            break
        time.sleep(0.02)
    assert set(threading.enumerate()) <= before, "worker thread leaked"

    assert list(prefetch(iter(range(7)), depth=3)) == list(range(7))

    def bad():
        yield 1
        raise ValueError("boom")

    import pytest

    with pytest.raises(ValueError, match="boom"):
        list(prefetch(bad(), depth=1))
