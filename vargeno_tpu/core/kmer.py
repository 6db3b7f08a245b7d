"""Vectorized 2-bit k-mer codec (k=32) for the device path.

Bit layout matches the reference exactly: base at *string index* ``i`` of the
32-mer occupies bits ``[2i, 2i+1]`` of the packed 64-bit word (reference:
src/util.c:89-111 ``encode_kmer`` iterates from kmer[31] down to kmer[0],
shifting left, so kmer[0] lands in the low bits). A rolling shift drops base 0
and appends the new base at bits 62-63 (src/util.c:113-127 ``shift_kmer``).

On device a k-mer is a pair of uint32s: ``lo`` holds string bases 0..15
(bits 0..31 of the u64), ``hi`` holds bases 16..31 (bits 32..63). This matches
the reference's HI/LO split (src/util.h:21-25), which its jumpgates and
Bloom filters key on.

Base codes: A=0 C=1 G=2 T=3 N=4 (src/vartype.h:20-24). All functions operate
on uint8 code arrays (any batch shape); none touch strings.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32


def pack_kmers(codes):
    """Pack base codes into (hi, lo) uint32 k-mer words.

    codes: (..., 32) uint8/int array of 2-bit base codes (caller guarantees
    values in 0..3; N-handling is done by the caller with masks, mirroring
    the reference's encode_kmer N-abort, src/util.c:102).

    Returns (hi, lo): two (...,) uint32 arrays.
    """
    c = codes.astype(_U32)
    shifts = jnp.arange(16, dtype=_U32) * 2
    lo = jnp.sum(c[..., :16] << shifts, axis=-1, dtype=_U32)
    hi = jnp.sum(c[..., 16:32] << shifts, axis=-1, dtype=_U32)
    return hi, lo


def get_base(hi, lo, i):
    """Base code at string index ``i`` (static or traced int array).

    Mirrors src/util.c:129-133 ``kmer_get_base``.
    """
    i = jnp.asarray(i, _U32)
    use_hi = i >= 16
    sh = jnp.where(use_hi, (i - 16) * 2, i * 2)
    word = jnp.where(use_hi, hi, lo)
    return (word >> sh) & _U32(3)


def all_bases(hi, lo):
    """All 32 base codes of each k-mer: returns (..., 32) uint8.

    Used by the pileup walk (reference: src/qv.cc:1390-1392 walks all 32
    bases of every agreeing hit context).
    """
    shifts = jnp.arange(16, dtype=_U32) * 2
    lo_b = (lo[..., None] >> shifts) & _U32(3)
    hi_b = (hi[..., None] >> shifts) & _U32(3)
    return jnp.concatenate([lo_b, hi_b], axis=-1).astype(jnp.uint8)


def mutate_base(hi, lo, base_idx: int, new_code):
    """Return the k-mer with string base ``base_idx`` (static) replaced.

    Mirrors the neighbor enumeration ``(kmer & ~mask) | (j << i)``
    (reference: src/qv.cc:973, 1222).
    """
    new_code = jnp.asarray(new_code, _U32)
    if base_idx < 16:
        sh = 2 * base_idx
        mask = _U32(~(0x3 << sh) & 0xFFFFFFFF)
        return hi, (lo & mask) | (new_code << sh)
    sh = 2 * (base_idx - 16)
    mask = _U32(~(0x3 << sh) & 0xFFFFFFFF)
    return (hi & mask) | (new_code << sh), lo


def revcomp_codes(codes, length):
    """Reverse-complement base codes over the first ``length`` positions.

    codes: (..., L) uint8 codes, padded arbitrarily past ``length``.
    length: (...,) int32 per-row true length (multiple of 32).

    Complement of code c in 0..3 is 3-c; positions >= length are filled with
    BASE_N (=4) so downstream N-masks treat them as invalid, mirroring the
    reference's in-place char reversal of the truncated read
    (src/qv.cc:787-806). Note the reference leaves the quality string
    unreversed; callers must do the same.
    """
    L = codes.shape[-1]
    idx = jnp.arange(L, dtype=jnp.int32)
    src = length[..., None] - 1 - idx  # (..., L)
    valid = src >= 0
    src_c = jnp.clip(src, 0, L - 1)
    g = jnp.take_along_axis(codes, src_c.astype(jnp.int32), axis=-1)
    comp = jnp.where(g < 4, 3 - g, g)
    return jnp.where(valid, comp, jnp.uint8(4)).astype(jnp.uint8)


# --- host-side numpy mirrors (used by index build and the oracle) ---

_NP_BASE = np.full(256, 7, dtype=np.uint8)  # BASE_X
for ch, code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("N", 4)):
    _NP_BASE[ord(ch)] = code
    _NP_BASE[ord(ch.lower())] = code


def np_codes_from_bytes(seq_bytes: bytes) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (A0 C1 G2 T3 N4, other 7)."""
    arr = np.frombuffer(seq_bytes, dtype=np.uint8)
    return _NP_BASE[arr]


def np_pack_kmers_u64(codes: np.ndarray) -> np.ndarray:
    """(..., 32) codes -> packed uint64 k-mers (host)."""
    c = codes.astype(np.uint64)
    shifts = (np.arange(32, dtype=np.uint64) * np.uint64(2))
    return np.sum(c << shifts, axis=-1, dtype=np.uint64)


def np_rolling_kmers_u64(codes: np.ndarray) -> np.ndarray:
    """All overlapping 32-mers of a 1-D code array as uint64, vectorized.

    Equivalent to the rolling shift_kmer walk (reference: src/dictgen.c:26-47)
    but computed as 32 shifted adds. Caller masks out windows containing N.
    """
    n = codes.shape[0] - 32 + 1
    if n <= 0:
        return np.zeros((0,), dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    c = codes.astype(np.uint64)
    for j in range(32):
        out |= (c[j : j + n] & np.uint64(3)) << np.uint64(2 * j)
    return out


def np_window_has_n(codes: np.ndarray, k: int = 32) -> np.ndarray:
    """Boolean mask over windows: True if any of the k bases is not in 0..3."""
    bad = (codes > 3).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    return (cs[k:] - cs[:-k]) > 0


def np_revcomp_u64(kmers: np.ndarray) -> np.ndarray:
    """Reverse complement of packed uint64 k-mers (host mirror of
    src/util.c:139-180 rev_compl)."""
    x = kmers.astype(np.uint64)
    out = np.zeros_like(x)
    for i in range(32):
        base = (x >> np.uint64(2 * i)) & np.uint64(3)
        out |= (np.uint64(3) - base) << np.uint64(2 * (31 - i))
    return out


def np_encode_batch(codes: np.ndarray, n_kmers: np.ndarray, K: int):
    """numpy mirror of the device batch encode (engine/batch.py
    encode_batch; reference read-encoding semantics src/qv.cc:810-828).

    Returns (hi, lo) (B, K) uint32, kmer_valid (B, K) bool, read_ok (B,)
    bool. Fallback for native.encode_batch."""
    B = codes.shape[0]
    win = codes[:, : K * 32].reshape(B, K, 32).astype(np.uint32)
    good = win <= 3
    shifts = (np.arange(16, dtype=np.uint32) * 2)
    lo = np.sum(np.where(good[..., :16], win[..., :16], 0) << shifts,
                axis=-1, dtype=np.uint64).astype(np.uint32)
    hi = np.sum(np.where(good[..., 16:], win[..., 16:], 0) << shifts,
                axis=-1, dtype=np.uint64).astype(np.uint32)
    slot = np.arange(K)[None, :]
    in_read = slot < np.minimum(n_kmers, K)[:, None]
    win_bad = ~good.all(axis=-1)
    read_ok = ~(win_bad & in_read).any(axis=-1)
    kmer_valid = in_read & read_ok[:, None]
    return hi, lo, kmer_valid, read_ok
