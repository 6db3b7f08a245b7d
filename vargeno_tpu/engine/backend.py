"""Query backends: how the engine's probes are answered.

The batched pipeline (engine.batch) issues four kinds of dictionary probes:
exact ref / exact snp lookups, the ref jumpgate-block Hamming scan, and the
snp block Hamming scan (reference: src/qv.cc:194-264, 316-464). A backend
answers them with *materialized* row fields (pos/flag/snp_info), never row
ids, so the caller needs no access to the dictionary arrays themselves --
which is what makes the sharded-dictionary (all_to_all routed) backend a
drop-in (dist.sharded_dict).

``LocalBackend`` answers from a fully device-resident DeviceIndex, including
the reference's small-block scan stride bug (entry ``lo + sizeof*(j)``
tested, entry ``lo + j`` reported; qv.cc:359, 448).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from . import search
from .scan_ops import compact_src, cumsum_mask
from .device_index import DeviceIndex

U32 = jnp.uint32
I32 = jnp.int32


def _ctz32(x):
    return jnp.where(
        x == 0, jnp.int32(32),
        jax.lax.population_count((x & (~x + U32(1))) - U32(1)).astype(I32))


@dataclasses.dataclass
class ScanResult:
    """Per-(item, slot) block-scan hits, in block order, zero-padded."""

    hit: jax.Array       # bool
    pos: jax.Array       # u32 (dict pos field: position | aux row | AMBIG)
    flag: jax.Array      # u8
    info: jax.Array      # u8 (snp_info; zeros for ref scans)
    nb_hi: jax.Array     # u32 neighbor kmer hi (as reference constructs it)
    nb_lo: jax.Array     # u32 neighbor kmer lo
    diff: jax.Array      # i32 mutated base index
    overflow: jax.Array  # scalar i32 truncated hits/slots


class LocalBackend:
    """All dictionaries resident on every device."""

    scan_slots = 100  # == BLOCK_SIZE_THRESHOLD: no truncation possible

    def __init__(self, dix: DeviceIndex, stride_bug: bool,
                 block_size_threshold: int, scan_slot_cap: int = 100,
                 sparse_frac: float = 0.25, active_frac: float = 0.25,
                 scan_active_frac: float = 1.0):
        self.dix = dix
        self.stride_bug = stride_bug
        self.S = block_size_threshold
        self.scan_slots = min(scan_slot_cap, block_size_threshold)
        self.scan_active_frac = scan_active_frac
        # no block ever exceeds the build-time measured maxima, so the
        # scan width shrinks to the data's bound (exact: larger blocks
        # take the big-block path / cannot exist)
        self.ref_scan_slots = max(1, min(self.scan_slots,
                                         getattr(dix, "ref_scan_max", 1 << 30)))
        self.snp_scan_slots = max(1, min(self.scan_slots,
                                         getattr(dix, "snp_scan_max", 1 << 30)))
        self.sparse_frac = sparse_frac
        self.active_frac = active_frac
        self._bounds_memo: dict = {}

    # --- exact queries: ONE bucket-row gather chain answers both
    # dictionaries (combined tagged table; hashtable.ht_lookup_both) ---

    def exact_both(self, q_hi, q_lo, valid=None):
        """(r_hit, r_pos, r_flag, s_hit, s_pos, s_info, s_flag); masked
        lanes' gathers coalesce to bucket 0."""
        from .hashtable import ht_lookup_both

        d = self.dix
        return ht_lookup_both(d.both_ht, d.both_ht_nb, d.both_ht_chain,
                              q_hi, q_lo, valid)

    def exact_ref(self, q_hi, q_lo, valid=None):
        """(hit, pos, flag)"""
        r = self.exact_both(q_hi, q_lo, valid)
        return r[0], r[1], r[2]

    def exact_snp(self, q_hi, q_lo, valid=None):
        """(hit, pos, info, flag)"""
        r = self.exact_both(q_hi, q_lo, valid)
        return r[3], r[4], r[5], r[6]

    # sparse variant: for probe sets that overwhelmingly MISS (Hamming
    # neighbors), test the one-bit union prefilter first and pay the
    # bucket-chain gathers only for the few % of lanes that pass
    sparse_overflow = None

    # second overflow counter: active-lane pre-compaction cap
    act_overflow = None

    # capacity-tuning telemetry (per-step maxima, not overflow counters):
    # real active / prefilter-passer / scan-test lane counts, so the bench
    # can right-size the _frac caps (every compacted-slot gather pays full
    # lane cost whether the slot is live or padding)
    act_lanes = None
    sparse_lanes = None
    ref_scan_lanes = None
    snp_scan_lanes = None

    def exact_both_sparse(self, q_hi, q_lo, act_ref, act_snp):
        """Combined lookup over lanes where either dictionary is being
        probed: ONE compaction to active lanes (typically 5-25% of the
        probe grid -- Bloom bounds and base!=current masks kill the rest),
        then a DIRECT bucket-row lookup on the compacted lanes.

        A one-bit membership prefilter + second compaction used to sit
        between them, but an in-step trace on the chip this engine was
        first tuned on showed the filter costing more than the 512 B
        bucket-row probes it pruned (tools/bench_rowwidth.py re-measures
        the row rates). Returns the
        exact_both 7-tuple with hits masked by the per-dict activity
        masks."""
        from .hashtable import ht_lookup_both

        d = self.dix
        shp = q_hi.shape
        qh = q_hi.reshape(-1)
        ql = q_lo.reshape(-1)
        ar = act_ref.reshape(-1)
        as_ = act_snp.reshape(-1)
        v = ar | as_
        N = qh.shape[0]

        # --- compaction: active lanes (packed (qh, ql) row gather) ---
        NC = max(64, min(N, int(N * self.active_frac)))
        act_n = jnp.sum(v, dtype=I32)
        self.act_lanes = act_n if self.act_lanes is None \
            else jnp.maximum(self.act_lanes, act_n)
        src_a, ovf_a = compact_src(v, NC)
        if self.act_overflow is None:
            self.act_overflow = jnp.zeros((), I32)
        self.act_overflow = self.act_overflow + ovf_a
        a_ok = src_a >= 0
        sa = jnp.maximum(src_a, 0)
        keys = jnp.stack([qh, ql], axis=-1)          # (N, 2)
        krows = jnp.where(a_ok[:, None], jnp.take(keys, sa, axis=0), U32(0))
        qh_c = krows[:, 0]
        ql_c = krows[:, 1]

        (r_hit, r_pos, r_flag, s_hit, s_pos, s_info, s_flag) = \
            ht_lookup_both(d.both_ht, d.both_ht_nb, d.both_ht_chain,
                           qh_c, ql_c, a_ok)
        # scatter-back straight to the ORIGINAL lane ids; one scalar
        # scatter per result word (scalar-element scatters measured far
        # faster than row scatters on the chip this engine was first
        # tuned on; tools/bench_gather.py re-measures both)
        bits = (r_hit.astype(U32) | (s_hit.astype(U32) << 1)
                | (r_flag.astype(U32) << 8) | (s_flag.astype(U32) << 16)
                | (s_info.astype(U32) << 24))
        orig = jnp.where(a_ok, sa, N)                # NC lanes
        fr_pos = jnp.zeros(N, U32).at[orig].set(
            jnp.where(a_ok, r_pos, U32(0)), mode="drop",
            unique_indices=True).reshape(shp)
        fs_pos = jnp.zeros(N, U32).at[orig].set(
            jnp.where(a_ok, s_pos, U32(0)), mode="drop",
            unique_indices=True).reshape(shp)
        fb = jnp.zeros(N, U32).at[orig].set(
            jnp.where(a_ok, bits, U32(0)), mode="drop",
            unique_indices=True).reshape(shp)
        fr_hit = ((fb & U32(1)) != 0) & act_ref
        fs_hit = ((fb & U32(2)) != 0) & act_snp
        fr_flag = ((fb >> 8) & U32(0xFF)).astype(jnp.uint8)
        fs_flag = ((fb >> 16) & U32(0xFF)).astype(jnp.uint8)
        fs_info = ((fb >> 24) & U32(0xFF)).astype(jnp.uint8)
        return (fr_hit, fr_pos, fr_flag, fs_hit, fs_pos, fs_info, fs_flag)

    def _ref_block_bounds(self, q_hi):
        """(start_row, size) of the hi32 jumpgate block (the reference's
        2^32 jumpgate, qv.cc:528-584).  The hi24 jumpgate narrows to the
        [a, b) hi24 block; one static-width aligned window gather over
        ref_hi (reshaped (n/32, 32) for free -- rows padded to a 32
        multiple at build) then resolves the exact hi32 sub-block with
        vector compares: same HBM bytes as one bucket probe, no 4.3 GB
        block-directory table.

        Memoized per traced query array: within one step the same items'
        bounds are needed by both ref_block_size and ref_scan, and the
        window gather is the scan path's largest -- computing it once
        halves that traffic."""
        memo = self._bounds_memo.get(id(q_hi))
        if memo is not None and memo[0] is q_hi:
            return memo[1]
        r = self._ref_block_bounds_impl(q_hi)
        self._bounds_memo[id(q_hi)] = (q_hi, r)
        return r

    def _ref_block_bounds_impl(self, q_hi):
        d = self.dix
        h24 = (q_hi >> U32(8)).astype(I32)
        a = d.ref_jg[h24].astype(I32)
        b = d.ref_jg[h24 + 1].astype(I32)
        g = d.ref_win_rows
        hi2d = (d.ref_hi if d.ref_hi.ndim == 2
                else d.ref_hi.reshape(-1, 32))
        r0 = jnp.minimum(a >> 5, hi2d.shape[0] - 1)
        rows = jnp.take(hi2d, jnp.minimum(
            r0[:, None] + jnp.arange(g, dtype=I32)[None, :],
            hi2d.shape[0] - 1), axis=0)            # (NI, g, 32)
        win = rows.reshape(q_hi.shape[0], g * 32)
        gidx = (r0 * 32)[:, None] + jnp.arange(g * 32, dtype=I32)[None, :]
        eq = (gidx >= a[:, None]) & (gidx < b[:, None]) \
            & (win == q_hi[:, None])
        size = jnp.sum(eq, axis=1, dtype=I32)
        first = jnp.argmax(eq, axis=1).astype(I32)
        start = jnp.where(size > 0, r0 * 32 + first, 0)
        return start, size

    def _snp_block_bounds(self, q_hi24):
        """snp blocks ARE hi24 blocks (reference 2^24 jumpgate,
        qv.cc:615-678): two 4-byte jumpgate gathers give exact bounds."""
        d = self.dix
        h = q_hi24.astype(I32)
        a = d.snp_jg[h].astype(I32)
        b = d.snp_jg[h + 1].astype(I32)
        return a, b - a

    def ref_block_size(self, q_hi):
        _, size = self._ref_block_bounds(q_hi)
        return size

    # stride-bug read limits: index beyond this reads as 0 (fresh-mmap heap
    # model); sharded subclasses override with the true unsharded extent
    def _ref_limit(self):
        # true (pre-padding) extent; pad rows read as zero either way
        return self.dix.n_ref_rows

    def _snp_limit(self):
        return self.dix.n_snp_rows

    # --- block Hamming scans ---

    def _scan_lanes(self, NI: int, S: int, active, bsize, which: str):
        """Compact the (item, slot) scan grid to its REAL test lanes
        (j < block size; typical blocks are 1-2 rows against 13-24
        slots), so the dictionary-row gathers run on ~block-sum lanes
        instead of the full grid. Returns (ci, cj, c_ok, spill)."""
        j = jnp.arange(S, dtype=I32)[None, :]
        mask = (active[:, None] & (j < bsize[:, None])).reshape(-1)
        CS = max(64, int(NI * S * min(self.scan_active_frac, 1.0)))
        sc_n = jnp.sum(mask, dtype=I32)
        attr = which + "_scan_lanes"
        prev = getattr(self, attr)
        setattr(self, attr,
                sc_n if prev is None else jnp.maximum(prev, sc_n))
        csrc, spill = compact_src(mask, CS)
        c_ok = csrc >= 0
        cs = jnp.maximum(csrc, 0)
        return cs // S, cs % S, cs, c_ok, spill

    def _scan_back(self, NI: int, S: int, cs, c_ok, c_hit, fields):
        """Scatter compacted per-lane results back to (NI, S) grids (only
        hit lanes are ever read downstream); one scalar scatter each."""
        tgt = jnp.where(c_ok, cs, NI * S)
        hit = jnp.zeros(NI * S, bool).at[tgt].set(
            c_hit, mode="drop", unique_indices=True).reshape(NI, S)
        outs = []
        for f in fields:
            z = jnp.zeros(NI * S, f.dtype)
            outs.append(z.at[tgt].set(
                jnp.where(c_hit, f, jnp.zeros((), f.dtype)), mode="drop",
                unique_indices=True).reshape(NI, S))
        return hit, outs

    def ref_scan(self, q_hi, q_lo, active) -> ScanResult:
        """Small-block ref scan for each item; `active` masks items."""
        d = self.dix
        S = self.ref_scan_slots
        NI = q_hi.shape[0]
        n_ref = self._ref_limit()
        blo, bsize = self._ref_block_bounds(q_hi)
        ci, cj, cs, c_ok, spill = self._scan_lanes(NI, S, active, bsize,
                                                   "ref")
        c_blo = blo[ci]
        stride = 9 if self.stride_bug else 1
        tidx = c_blo + stride * cj
        test_lo = jnp.where(c_ok & (tidx < n_ref),
                            jnp.take(d.ref_lo, jnp.minimum(tidx, n_ref - 1),
                                     axis=0), U32(0))
        x = q_lo[ci] ^ test_lo
        tz = _ctz32(x)
        k2 = tz >> 1
        sh2 = jnp.minimum(2 * k2, 31).astype(U32)
        c_hit = c_ok & (x != 0) & ((x >> sh2) <= 3)
        mr = jnp.minimum(c_blo + cj, d.ref_meta.shape[0] - 1)
        meta = jnp.take(d.ref_meta, mr, axis=0, mode="clip")  # (CS, 2)
        hit, (pos, flag, nb_lo, diff) = self._scan_back(
            NI, S, cs, c_ok, c_hit,
            [meta[:, 0], (meta[:, 1] & U32(0xFF)).astype(jnp.uint8),
             test_lo, k2])
        return ScanResult(
            hit=hit, pos=pos, flag=flag,
            info=jnp.zeros((NI, S), jnp.uint8),
            nb_hi=jnp.broadcast_to(q_hi[:, None], (NI, S)),
            nb_lo=nb_lo, diff=diff,
            overflow=spill + jnp.sum(jnp.maximum(
                jnp.where(active & (bsize < self.S), bsize, 0) - S, 0)))

    def snp_scan(self, q_hi, q_lo, active) -> ScanResult:
        d = self.dix
        S = self.snp_scan_slots
        NI = q_hi.shape[0]
        n_snp = self._snp_limit()
        slo, ssize = self._snp_block_bounds(q_hi >> 8)
        ci, cj, cs, c_ok, spill = self._scan_lanes(NI, S, active, ssize,
                                                   "snp")
        c_slo = slo[ci]
        stride = 11 if self.stride_bug else 1
        tidx = c_slo + stride * cj
        in_dict = c_ok & (tidx < n_snp)
        tst = jnp.take(d.snp_test, jnp.minimum(tidx, n_snp - 1),
                       axis=0)                               # (CS, 2)
        e_lo = jnp.where(in_dict, tst[:, 0], U32(0))
        e_hi8 = jnp.where(in_dict, tst[:, 1], U32(0))
        c_qhi = q_hi[ci]
        xlo = q_lo[ci] ^ e_lo
        xhi8 = (c_qhi & U32(0xFF)) ^ e_hi8
        tz40 = jnp.where(xlo != 0, _ctz32(xlo), 32 + _ctz32(xhi8))
        k2s = tz40 >> 1
        sh_lo = jnp.clip(2 * k2s, 0, 31).astype(U32)
        sh_hi = jnp.clip(2 * k2s - 32, 0, 31).astype(U32)
        ok_lo = (xhi8 == 0) & ((xlo >> sh_lo) <= 3)
        ok_hi = (xlo == 0) & ((xhi8 >> sh_hi) <= 3)
        c_hit = c_ok & jnp.where(tz40 < 32, ok_lo, ok_hi) \
            & ((xlo | xhi8) != 0)
        mr = jnp.minimum(c_slo + cj, d.snp_meta.shape[0] - 1)
        meta = jnp.take(d.snp_meta, mr, axis=0, mode="clip")  # (CS, 2)
        hit, (pos, flag, info, nb_hi, nb_lo, diff) = self._scan_back(
            NI, S, cs, c_ok, c_hit,
            [meta[:, 0], (meta[:, 1] & U32(0xFF)).astype(jnp.uint8),
             ((meta[:, 1] >> 8) & U32(0xFF)).astype(jnp.uint8),
             (c_qhi & U32(0xFFFFFF00)) | e_hi8, e_lo, k2s])
        return ScanResult(
            hit=hit, pos=pos, flag=flag, info=info,
            nb_hi=nb_hi, nb_lo=nb_lo, diff=diff,
            overflow=spill + jnp.sum(jnp.maximum(
                jnp.where(active & (ssize < 0x10000), ssize, 0) - S, 0)))
