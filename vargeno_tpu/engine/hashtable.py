"""Bucketized open-addressing hash table for exact k-mer lookups.

The reference resolves an exact lookup with a 16 GiB jumpgate load plus a
binary search (src/qv.cc:206-240). A device gather costs full memory
latency and a branchless binary search needs ~2*ceil(log2 n) dependent
gathers, so the lookup structure is redesigned around wide rows: keys live in
8-slot buckets laid out as one contiguous 128-byte row, probing fetches ONE
row per visited bucket (a single gather descriptor) and compares all 8 slots
in vector registers. Linear probing across buckets; the number of unrolled
bucket visits is the build-time maximum chain length (typically 2 at the
0.5 load factor used here).

Row layout is FIELD-BLOCKED: [hi x S | lo x S | pos x S | meta x S]
uint32 (S slots/bucket), with meta = occupied<<31 | snp_info<<16 | flag --
field extraction on device is a contiguous lane slice of the gathered
128-lane row; the earlier per-slot interleaved layout forced XLA to emit
a relayout copy of every lookup's gathered rows.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.hashes import np_hash32, hash32

U32 = jnp.uint32
_MIX = 0x9E3779B9


def _bucket_hash_np(hi, lo, nb):
    with np.errstate(over="ignore"):
        h = np_hash32(lo) ^ (np_hash32(hi) * np.uint32(_MIX))
    return (h & np.uint32(nb - 1)).astype(np.int64)


@dataclasses.dataclass
class HostHashTable:
    table: np.ndarray   # (nb, 32) uint32
    nb: int
    chain: int


def build_hash_table(hi: np.ndarray, lo: np.ndarray, pos: np.ndarray,
                     flag: np.ndarray, info: np.ndarray | None,
                     slots_per_bucket: int = 32,
                     target_load: float = 0.5,
                     use_native: bool = True) -> HostHashTable:
    """32 slots/bucket = 128 u32 = one 512 B row per bucket.

    At 0.5 load a 32-slot bucket practically never overflows, so the probe
    chain bound is ~1 and one wide-row gather answers a lookup. The row
    width was chosen on the chip this engine was first tuned on; on the
    H100 a row is four 128 B lines, and tools/bench_rowwidth.py +
    tools/bench_gather.py re-measure the trade (ROADMAP 1.4).
    Memory: nb*512 B = ~32 B/key at 0.5 load."""
    n = hi.shape[0]
    nb = 1 << max(2, int(np.ceil(np.log2(
        max(n / (slots_per_bucket * target_load), 1.0)))))

    if use_native and n >= (1 << 16):
        from .. import native

        if native.available():
            # single-pass sequential insertion at memory speed; placement
            # differs from the numpy rounds but any consistent placement
            # with a valid chain bound yields identical lookups
            table, chain = native.ht_build(hi, lo, pos, flag, info, nb,
                                           slots_per_bucket)
            return HostHashTable(table=table, nb=nb, chain=chain)

    home = _bucket_hash_np(hi, lo, nb)

    bucket = home.copy()
    placed = np.full(n, -1, np.int64)
    cap = np.zeros(nb, np.int64)
    remaining = np.arange(n)
    rounds = 0
    while remaining.size:
        b = bucket[remaining]
        order = np.argsort(b, kind="stable")
        rb = b[order]
        start = np.searchsorted(rb, rb)
        within = np.arange(rb.size) - start
        free = slots_per_bucket - cap[rb]
        fits = within < free
        sel = remaining[order[fits]]
        placed[sel] = b[order[fits]]
        np.add.at(cap, b[order[fits]], 1)
        rem = remaining[order[~fits]]
        bucket[rem] = (bucket[rem] + 1) & (nb - 1)
        remaining = rem
        rounds += 1
        if rounds > 64:
            raise RuntimeError("hash table build did not converge")

    # lookup chain bound: longest run of completely-full buckets + 1
    full = cap >= slots_per_bucket
    if full.any():
        f2 = np.concatenate([full, full])  # cover wraparound runs
        zeros = np.flatnonzero(~f2)
        if zeros.size == 0:
            best = len(f2)
        else:
            edges = np.concatenate([[-1], zeros, [len(f2)]])
            best = int((np.diff(edges) - 1).max())
        chain = min(best + 1, nb)
    else:
        chain = 1
    if n:
        chain = max(chain, int(((placed - home) % nb).max()) + 1)

    # slot assignment within buckets; FIELD-BLOCKED row layout
    # [hi x S | lo x S | pos x S | meta x S]: device-side field extraction
    # is a contiguous lane slice of the gathered row (an interleaved
    # (S, 4) layout forced a relayout copy of every lookup's result)
    order2 = np.argsort(placed, kind="stable")
    pb = placed[order2]
    slot = np.arange(n) - np.searchsorted(pb, pb)
    S = slots_per_bucket
    table = np.zeros((nb, S * 4), np.uint32)
    rows = pb
    table[rows, slot] = hi[order2]
    table[rows, S + slot] = lo[order2]
    table[rows, 2 * S + slot] = pos[order2]
    meta = (np.uint32(1) << np.uint32(31)) | flag[order2].astype(np.uint32)
    if info is not None:
        meta = meta | (info[order2].astype(np.uint32) << np.uint32(16))
    table[rows, 3 * S + slot] = meta
    return HostHashTable(table=table, nb=nb, chain=int(chain))


def prefilter_bits(hi: np.ndarray, lo: np.ndarray, pf_bits: int
                   ) -> np.ndarray:
    """Host build of the full-key membership prefilter bitmap (LSB-first
    u32 words). One bit per key via the same bucket hash family; at a few
    percent fill this prunes ~97% of miss probes to a single gather."""
    with np.errstate(over="ignore"):
        h = np_hash32(lo) ^ (np_hash32(hi) * np.uint32(_MIX))
    bit = (h & np.uint32(pf_bits - 1)).astype(np.int64)
    words = np.zeros(pf_bits // 32, np.uint32)
    from .. import native

    if bit.size >= (1 << 16) and native.available():
        native.bf_set_bits(words, bit)
    else:
        np.bitwise_or.at(words, bit >> 5,
                         np.uint32(1) << (bit & 31).astype(np.uint32))
    return words


def prefilter_test(words, pf_bits: int, q_hi, q_lo, valid=None):
    h = hash32(q_lo) ^ (hash32(q_hi) * U32(_MIX))
    bit = h & U32(pf_bits - 1)
    if valid is not None:  # coalesce masked lanes' gathers onto word 0
        bit = jnp.where(valid, bit, U32(0))
    w = jnp.take(words, (bit >> 5).astype(jnp.int32), axis=0, mode="clip")
    hitbit = ((w >> (bit & U32(31))) & U32(1)) != 0
    return hitbit if valid is None else (hitbit & valid)


def ht_lookup_both(table2d, nb: int, chain: int, q_hi, q_lo, valid=None):
    """Combined-table lookup: ref and snp rows share buckets (snp rows
    carry tag bit 7 in the flag byte), so ONE chain of bucket-row gathers
    answers exact membership in BOTH dictionaries.

    Returns (r_hit, r_pos, r_flag, s_hit, s_pos, s_info, s_flag)."""
    shp = q_hi.shape
    if len(shp) != 1:
        # flatten-gather-reshape: a (B, K)-index row gather lowered
        # slower than the same gather with flat indices on the chip this
        # engine was first tuned on (tools/bench_gather.py re-measures it)
        out = ht_lookup_both(table2d, nb, chain, q_hi.reshape(-1),
                             q_lo.reshape(-1),
                             None if valid is None else valid.reshape(-1))
        return tuple(o.reshape(shp) for o in out)
    h = hash32(q_lo) ^ (hash32(q_hi) * U32(_MIX))
    b = (h & U32(nb - 1)).astype(jnp.int32)
    if valid is not None:
        b = jnp.where(valid, b, 0)
    S = table2d.shape[1] // 4
    shp = q_hi.shape
    r_found = jnp.zeros(shp, bool)
    s_found = jnp.zeros(shp, bool)
    r_pos = jnp.zeros(shp, U32)
    s_pos = jnp.zeros(shp, U32)
    r_meta = jnp.zeros(shp, U32)
    s_meta = jnp.zeros(shp, U32)
    for c in range(chain):
        row = jnp.take(table2d, (b + c) % nb, axis=0)
        # field-blocked row: contiguous lane slices, no relayout
        hi_s = row[..., 0:S]
        lo_s = row[..., S:2 * S]
        pos_s = row[..., 2 * S:3 * S]
        meta = row[..., 3 * S:4 * S]
        occ = (meta >> 31) != 0
        keyeq = occ & (hi_s == q_hi[..., None]) & (
            lo_s == q_lo[..., None])
        tag_snp = (meta & U32(0x80)) != 0
        for is_snp in (False, True):
            m = keyeq & (tag_snp if is_snp else ~tag_snp)
            anym = jnp.any(m, axis=-1)
            sel_pos = jnp.sum(jnp.where(m, pos_s, 0), axis=-1)
            sel_meta = jnp.sum(jnp.where(m, meta, 0), axis=-1)
            if is_snp:
                new = anym & ~s_found
                s_pos = jnp.where(new, sel_pos, s_pos)
                s_meta = jnp.where(new, sel_meta, s_meta)
                s_found = s_found | anym
            else:
                new = anym & ~r_found
                r_pos = jnp.where(new, sel_pos, r_pos)
                r_meta = jnp.where(new, sel_meta, r_meta)
                r_found = r_found | anym
    if valid is not None:
        r_found = r_found & valid
        s_found = s_found & valid
        r_pos = jnp.where(valid, r_pos, U32(0))
        s_pos = jnp.where(valid, s_pos, U32(0))
        r_meta = jnp.where(valid, r_meta, U32(0))
        s_meta = jnp.where(valid, s_meta, U32(0))
    r_flag = (r_meta & U32(0x7F)).astype(jnp.uint8)
    s_flag = (s_meta & U32(0x7F)).astype(jnp.uint8)
    s_info = ((s_meta >> 16) & U32(0xFF)).astype(jnp.uint8)
    return r_found, r_pos, r_flag, s_found, s_pos, s_info, s_flag


def ht_lookup(table2d, nb: int, chain: int, q_hi, q_lo, valid=None):
    """Returns (hit, pos, flag, info) for any query shape.

    ``valid`` (optional bool mask) routes masked-off lanes to bucket 0 so
    their gathers coalesce onto one cache line instead of scattering HBM
    traffic (results for those lanes are masked to miss)."""
    shp = q_hi.shape
    if len(shp) != 1:
        # flatten-gather-reshape (see ht_lookup_both)
        out = ht_lookup(table2d, nb, chain, q_hi.reshape(-1),
                        q_lo.reshape(-1),
                        None if valid is None else valid.reshape(-1))
        return tuple(o.reshape(shp) for o in out)
    h = hash32(q_lo) ^ (hash32(q_hi) * U32(_MIX))
    b = (h & U32(nb - 1)).astype(jnp.int32)
    if valid is not None:
        b = jnp.where(valid, b, 0)
    S = table2d.shape[1] // 4
    found = jnp.zeros(q_hi.shape, bool)
    pos = jnp.zeros(q_hi.shape, U32)
    meta = jnp.zeros(q_hi.shape, U32)
    for c in range(chain):
        row = jnp.take(table2d, (b + c) % nb, axis=0)  # (..., S*4)
        hi_s = row[..., 0:S]
        lo_s = row[..., S:2 * S]
        pos_s = row[..., 2 * S:3 * S]
        meta_s = row[..., 3 * S:4 * S]
        occ = (meta_s >> 31) != 0
        m = occ & (hi_s == q_hi[..., None]) & (
            lo_s == q_lo[..., None])
        anym = jnp.any(m, axis=-1)
        sel_pos = jnp.sum(jnp.where(m, pos_s, 0), axis=-1)
        sel_meta = jnp.sum(jnp.where(m, meta_s, 0), axis=-1)
        new = anym & ~found
        pos = jnp.where(new, sel_pos, pos)
        meta = jnp.where(new, sel_meta, meta)
        found = found | anym
    if valid is not None:  # rerouted lanes must read as misses
        found = found & valid
        pos = jnp.where(valid, pos, U32(0))
        meta = jnp.where(valid, meta, U32(0))
    flag = (meta & U32(0xFF)).astype(jnp.uint8)
    info = ((meta >> 16) & U32(0xFF)).astype(jnp.uint8)
    return found, pos, flag, info
