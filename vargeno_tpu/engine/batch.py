"""The batched device genotyping engine.

Re-architects the reference's per-read sequential loop (src/qv.cc:760-1558)
as a fixed-shape data-parallel pipeline over B reads x K k-mers:

  encode -> exact lookups -> low-quality k-mer compaction -> neighbor probe
  grid -> probe-hit compaction -> aux/event expansion into an ordered
  (B, E) event buffer -> sequential vote scan (exact reference semantics)
  -> orientation select -> agreeing-context compaction -> pileup scatter.

Everything is masked dense ops; per-batch "overflow" counters report any
truncation against the reference's unbounded (or 2000-capped) buffers so
tests can assert zero divergence.

Event ORDER inside a read reproduces the reference exactly: per k-mer, the
exact ref hit(s), the exact snp hit(s), then (quality-gated) the lo-half
neighbor events (small-block Hamming scans of the ref then snp jumpgate
blocks, qv.cc:1110-1209, or the big-block 96-probe enumeration,
qv.cc:962-1108) and the hi-half probe events (qv.cc:1213-1365), because the
vote state machine (improved_index_table_add, qv.cc:132-178) is
order-sensitive.

Dictionary probes are answered through a pluggable backend (engine.backend):
LocalBackend for a replicated index, dist.sharded_dict.RoutedBackend for a
hi-bit-partitioned index with all_to_all k-mer routing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GenoConfig, NO_MODIFICATION, POS_AMBIGUOUS
from ..core import hashes
from . import search
from .backend import LocalBackend
from .scan_ops import compact_src, cumsum_mask
from .device_index import DeviceIndex

U32 = jnp.uint32
I32 = jnp.int32

# numpy scalars, NOT jnp (module-level jnp constants would initialize
# the XLA backend at import, breaking jax.distributed.initialize ordering)
_NO_MOD = np.int32(NO_MODIFICATION)
_POS_AMBIG = np.uint32(POS_AMBIGUOUS)


def encode_batch(codes, n_kmers, K: int):
    """codes (B, L) u8 -> kmer (hi, lo) (B, K) u32 + validity.

    A read whose first n_kmers*32 bases contain any non-ACGT code is dropped
    entirely (src/qv.cc:812-828: N aborts the orientation AND the read)."""
    B = codes.shape[0]
    win = codes[:, : K * 32].reshape(B, K, 32)
    shifts = jnp.arange(16, dtype=U32) * 2
    c = win.astype(U32)
    lo = jnp.sum(jnp.where(win[..., :16] <= 3, c[..., :16], 0) << shifts,
                 axis=-1, dtype=U32)
    hi = jnp.sum(jnp.where(win[..., 16:] <= 3, c[..., 16:], 0) << shifts,
                 axis=-1, dtype=U32)
    slot = jnp.arange(K, dtype=I32)[None, :]
    in_read = slot < n_kmers[:, None]
    win_bad = jnp.any(win > 3, axis=-1)
    read_ok = ~jnp.any(win_bad & in_read, axis=-1)
    kmer_valid = in_read & read_ok[:, None]
    return hi, lo, kmer_valid, read_ok


@dataclasses.dataclass
class _Shapes:
    B: int
    K: int
    E: int
    C: int
    NI: int   # neighbor work items
    H: int    # compacted probe hits per item
    A: int    # agreeing contexts per read
    SC: int   # extracted site slots per pileup context


def _bitrev2_u32(x):
    """Reverse the sixteen 2-bit fields of a uint32."""
    m2 = U32(0x33333333)
    m4 = U32(0x0F0F0F0F)
    m8 = U32(0x00FF00FF)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return (x << 16) | (x >> 16)


def rc_enc(hi, lo, kmer_valid, read_ok, n_kmers, K: int):
    """Reverse-complement orientation of an encoded batch, derived from the
    packed kmer words alone (reference semantics: the read -- truncated to
    nk*32 bases -- is reverse-complemented in place and re-encoded,
    src/qv.cc:787-806; with 32-aligned truncation, RC kmer j is the
    base-reversed complement of forward kmer nk-1-j). Validity masks are
    symmetric under RC, so they carry over unchanged."""
    rhi = _bitrev2_u32(~lo)
    rlo = _bitrev2_u32(~hi)
    j = jnp.arange(K, dtype=I32)[None, :]
    src = jnp.clip(n_kmers[:, None].astype(I32) - 1 - j, 0, K - 1)
    take_k = lambda a: jnp.take_along_axis(a, src, axis=1)
    return take_k(rhi), take_k(rlo), kmer_valid, read_ok


def _get_base(hi, lo, i):
    use_hi = i >= 16
    sh = jnp.where(use_hi, 2 * (i - 16), 2 * i).astype(U32)
    word = jnp.where(use_hi, hi, lo)
    return ((word >> sh) & U32(3)).astype(jnp.uint8)


def vote_scan(ev_idx, ev_k, ev_isnb, ev_valid, C: int):
    """Sequential per-read vote over the event buffer
    (improved_index_table_add, qv.cc:132-178).

    ev_* are (E, B) event fields in event order. The carry is each read's
    candidate table (C slots) plus its live best state; every per-step
    lookup is a one-hot reduction over the C axis. Returns
    (process (B,) bool, target (B,) u32, cand_overflow scalar i32): an
    event that would insert into a full table is dropped and counted."""
    B = ev_idx.shape[1]
    c_iota = jnp.arange(C, dtype=I32)[None, :]

    def vote_step(carry, ev):
        (cidx, cfreq, ckm, ncand, best, bfreq, bidx, amb, covf) = carry
        e_idx, e_k, e_isnb, e_val = ev
        used = c_iota < ncand[:, None]
        match = used & (cidx == e_idx[:, None])
        found = jnp.any(match, axis=1)
        accept = e_val & (found | ~e_isnb)
        can_ins = ncand < C
        insert = accept & ~found
        eff = accept & (found | can_ins)
        ins_hot = (c_iota == ncand[:, None]) & (insert & can_ins)[:, None]
        onehot = (match & accept[:, None]) | ins_hot
        cidx = jnp.where(onehot, e_idx[:, None], cidx)
        cfreq = cfreq + onehot.astype(I32)
        ckm_new = ckm | jnp.where(
            onehot, U32(1) << e_k[:, None].astype(U32), U32(0))
        ncand = ncand + (insert & can_ins).astype(I32)
        covf = covf + jnp.sum(insert & ~can_ins)

        # f, eligibility via one-hot reductions
        f = jnp.sum(jnp.where(onehot, cfreq, 0), axis=1)
        km_sel = jnp.sum(jnp.where(onehot, ckm_new, U32(0)), axis=1)
        elig = jax.lax.population_count(km_sel).astype(I32) >= 2
        upd = eff & elig
        has_best = best >= 0
        is_best = eff & (e_idx == bidx) & has_best
        # keep bfreq live: +1 whenever the best candidate's freq grew
        bfreq = bfreq + is_best.astype(I32)
        ckm = ckm_new

        slot = jnp.sum(jnp.where(onehot, c_iota, 0), axis=1)
        take_new = upd & (~has_best | (~is_best & (f > bfreq)))
        set_amb = upd & has_best & ~is_best & (f == bfreq)
        clr_amb = upd & (is_best | ~has_best | (f > bfreq))
        best = jnp.where(take_new, slot, best)
        bidx = jnp.where(take_new, e_idx, bidx)
        bfreq = jnp.where(take_new, f, bfreq)
        amb = jnp.where(set_amb, True, jnp.where(clr_amb, False, amb))
        return (cidx, cfreq, ckm, ncand, best, bfreq, bidx, amb,
                covf), None

    with jax.named_scope("vote"):
        carry = (jnp.zeros((B, C), U32), jnp.zeros((B, C), I32),
                 jnp.zeros((B, C), U32), jnp.zeros(B, I32),
                 jnp.full(B, -1, I32), jnp.zeros(B, I32),
                 jnp.zeros(B, U32), jnp.zeros(B, bool), jnp.zeros((), I32))
        carry, _ = jax.lax.scan(vote_step, carry,
                                (ev_idx, ev_k, ev_isnb, ev_valid))
        best, best_freq, best_idx, amb, cand_ovf = carry[4:]
        has_best = best >= 0
        target = jnp.where(has_best, best_idx, U32(0))
        process = has_best & (best_freq > 1) & ~amb
    return process, target, cand_ovf


def _lane_telemetry(be, stats: dict) -> None:
    """Surface the backend's real compacted-lane counts as *_max stats so
    the host (and the bench capacity report) can right-size the _frac caps;
    every compacted-slot gather pays full lane cost whether the slot is
    live or padding, so caps far above the real maxima are pure waste."""
    for attr, key in (("act_lanes", "act_lanes_max"),
                      ("sparse_lanes", "sparse_lanes_max"),
                      ("ref_scan_lanes", "ref_scan_lanes_max"),
                      ("snp_scan_lanes", "snp_scan_lanes_max")):
        v = getattr(be, attr, None)
        if v is not None:
            stats[key] = v


def make_batch_processor(dix: DeviceIndex, config: GenoConfig,
                         return_debug: bool = False,
                         backend_factory: Optional[Callable] = None,
                         _ablate: str = ""):
    """Build the jitted per-batch step.

    step(codes(B,L)u8, n_kmers(B,)i32, qual(B,K)u8, ref_cnt(s,), alt_cnt(s,))
      -> (ref_cnt', alt_cnt', stats)  [+ debug dict when return_debug]

    The index arrays thread through jit as a pytree argument (NOT captured
    constants -- a 1.2 GB Bloom filter must not be baked into the HLO).
    """
    host_dix = dix
    cfg = config
    sh = _Shapes(
        B=cfg.batch_reads, K=cfg.max_kmers_per_read, E=cfg.events_per_read,
        C=cfg.candidates_per_read,
        NI=max(8, int(cfg.batch_reads * cfg.max_kmers_per_read
                      * cfg.neighbor_item_frac)),
        H=cfg.probe_hit_cap, A=cfg.agree_cap,
        SC=min(cfg.sites_per_context, 32))

    if backend_factory is None:
        def backend_factory(dix_t):
            return LocalBackend(dix_t, cfg.replicate_stride_bug,
                                cfg.block_size_threshold,
                                cfg.scan_slot_cap, cfg.sparse_frac,
                                cfg.probe_active_frac,
                                cfg.scan_active_frac)

    # probe slot geometry depends on the backend's scan capacities
    _be0 = backend_factory(dix)
    SCAN = _be0.scan_slots
    P_SMALL = (getattr(_be0, "ref_scan_slots", SCAN)
               + getattr(_be0, "snp_scan_slots", SCAN))
    # if no ref hi32 block can reach the big-block threshold (build-time
    # measured maximum), the big-block lo-half enumeration (qv.cc:962-1108)
    # is statically dead: elide its 128 probe grid columns entirely
    NO_BIG = (getattr(dix, "ref_scan_max", 1 << 30)
              < cfg.block_size_threshold)
    P_BIGLO = 0 if NO_BIG else 16 * 4 * 2
    P_HI = 16 * 4 * 2
    P2 = P_SMALL + P_BIGLO + P_HI

    def take(arr, idx):
        return jnp.take(arr, idx, axis=0, mode="clip")

    # ------------------------------------------------------------------
    def _pack_meta(is_ref, diff, flag, info):
        """Pack the narrow probe fields into one u32 word:
        bit0 is_ref | bits1-6 diff | bits8-15 flag | bits16-23 info."""
        return (is_ref.astype(U32)
                | (diff.astype(U32) << 1)
                | (flag.astype(U32) << 8)
                | (info.astype(U32) << 16))

    def neighbor_probes(be, dix, it_hi, it_lo, it_valid):
        """All neighbor probes for NI work items -> hit mask (NI, P2) plus
        ONE packed row tensor (NI, P2, 4) u32 [pos, nb_hi, nb_lo, meta], so
        the downstream hit compaction is a single row gather instead of
        eight per-field gathers. Column order inside P2 (= within-item
        event order) matches the reference exactly: small ref scan, small
        snp scan, interleaved big-lo ref/snp, interleaved hi ref/snp."""
        NI = it_hi.shape[0]
        if NO_BIG:
            big = jnp.zeros(NI, bool)
        else:
            bsize = be.ref_block_size(it_hi)
            big = bsize >= jnp.int32(cfg.block_size_threshold)

        # Bloom-filter pruning (qv.cc:946-956)
        ref_bit = hashes.hash32(it_lo)
        if dix.ref_bf_bits < (1 << 32):  # identity at reference geometry
            ref_bit = ref_bit % U32(dix.ref_bf_bits)
        ref_hit_bf = search.bitmap_test(dix.ref_bf, ref_bit)
        snp_bit = hashes.snp_bf_bit(it_hi & U32(0xFF), it_lo,
                                    dix.snp_bf_bits)
        snp_hit_bf = search.bitmap_test(dix.snp_bf, snp_bit)
        ref_bound = jnp.where(ref_hit_bf, 64, 32)
        snp_bound = jnp.where(snp_hit_bf, 64, 40)

        def rows_of(pos, nb_hi, nb_lo, meta):
            shp = jnp.broadcast_shapes(pos.shape, nb_hi.shape, nb_lo.shape,
                                       meta.shape)
            return jnp.stack([jnp.broadcast_to(pos.astype(U32), shp),
                              jnp.broadcast_to(nb_hi, shp),
                              jnp.broadcast_to(nb_lo, shp),
                              jnp.broadcast_to(meta, shp)], axis=-1)

        # --- small-block scans (ref then snp) ---
        rs = be.ref_scan(it_hi, it_lo, it_valid & ~big)
        ss = be.snp_scan(it_hi, it_lo, it_valid & ~big)
        scan_overflow = rs.overflow + ss.overflow
        hit_scan = [rs.hit, ss.hit]
        rows_scan = [
            rows_of(rs.pos, rs.nb_hi, rs.nb_lo,
                    _pack_meta(jnp.ones_like(rs.hit), rs.diff, rs.flag,
                               rs.info)),
            rows_of(ss.pos, ss.nb_hi, ss.nb_lo,
                    _pack_meta(jnp.zeros_like(ss.hit), ss.diff, ss.flag,
                               ss.info))]

        bases = jnp.arange(16, dtype=I32)
        jj = jnp.arange(4, dtype=I32)
        bgrid = jnp.repeat(bases, 4)[None, :]            # (1, 64)
        jgrid = jnp.tile(jj, 16)[None, :]

        bgrid_h = bgrid + 16
        bitpos = 2 * bgrid_h
        cur_h = ((it_hi[:, None] >> (2 * bgrid).astype(U32)) & U32(3))
        base_ok = jgrid != cur_h.astype(I32)
        nb_hi_h = ((it_hi[:, None] & ~(U32(3) << (2 * bgrid).astype(U32)))
                   | (jgrid.astype(U32) << (2 * bgrid).astype(U32)))
        nb_lo_h = jnp.broadcast_to(it_lo[:, None], nb_hi_h.shape)
        act_ref = (it_valid[:, None] & base_ok
                   & (bitpos < ref_bound[:, None]))
        act_snp = (it_valid[:, None] & base_ok
                   & (big[:, None] | (bitpos >= 40))
                   & (bitpos < snp_bound[:, None]))

        if NO_BIG:
            # big-block lo-half enumeration statically dead: the hi-half
            # grids ARE the whole sparse-probe grid (NI, 64)
            q_hi_all, q_lo_all = nb_hi_h, nb_lo_h
            act_ref_all, act_snp_all = act_ref, act_snp
        else:
            # neighbor key grids: big-block lo-half enumeration
            # (qv.cc:965-1108) ahead of the hi-half probes
            cur = ((it_lo[:, None] >> (2 * bgrid).astype(U32)) & U32(3))
            act_bl = it_valid[:, None] & big[:, None] \
                & (jgrid != cur.astype(I32))
            nb_lo_big = ((it_lo[:, None]
                          & ~(U32(3) << (2 * bgrid).astype(U32)))
                         | (jgrid.astype(U32) << (2 * bgrid).astype(U32)))
            nb_hi_big = jnp.broadcast_to(it_hi[:, None], nb_lo_big.shape)

            # ONE sparse combined lookup over the concatenated lo+hi grids
            # (NI, 128): one prefilter test + one row-gather chain answers
            # both dictionaries for every neighbor probe
            q_hi_all = jnp.concatenate([nb_hi_big, nb_hi_h], axis=1)
            q_lo_all = jnp.concatenate([nb_lo_big, nb_lo_h], axis=1)
            act_ref_all = jnp.concatenate([act_bl, act_ref], axis=1)
            act_snp_all = jnp.concatenate([act_bl, act_snp], axis=1)
        if hasattr(be, "exact_both_sparse"):
            (r_hit, r_pos, r_flag, s_hit, s_pos, s_info, s_flag) = \
                be.exact_both_sparse(q_hi_all, q_lo_all, act_ref_all,
                                     act_snp_all)
        else:  # routed backend: per-dict all_to_all lookups
            r_hit, r_pos, r_flag = be.exact_ref(q_hi_all, q_lo_all,
                                                act_ref_all)
            s_hit, s_pos, s_info, s_flag = be.exact_snp(q_hi_all, q_lo_all,
                                                        act_snp_all)

        PG = q_hi_all.shape[1]   # 64 (hi only) or 128 (lo+hi)
        if NO_BIG:
            diff_all = jnp.broadcast_to(bgrid_h, (NI, PG))
        else:
            diff_all = jnp.concatenate(
                [jnp.broadcast_to(bgrid, (NI, 64)),
                 jnp.broadcast_to(bgrid_h, (NI, 64))], axis=1)
        rows_ref = rows_of(
            r_pos, q_hi_all, q_lo_all,
            _pack_meta(jnp.ones((NI, PG), U32), diff_all, r_flag,
                       jnp.zeros((NI, PG), U32)))
        rows_snp = rows_of(
            s_pos, q_hi_all, q_lo_all,
            _pack_meta(jnp.zeros((NI, PG), U32), diff_all, s_flag,
                       s_info))
        hit_ref = act_ref_all & r_hit
        hit_snp = act_snp_all & s_hit

        def interleave(a_ref, a_snp):
            # (NI, 128[, 4]) pair -> (NI, 256[, 4]) r0,s0,r1,s1,... order
            trailing = a_ref.shape[2:]
            return jnp.stack([a_ref, a_snp], axis=2).reshape(
                (a_ref.shape[0], 2 * a_ref.shape[1]) + trailing)

        p_hit = jnp.concatenate(
            hit_scan + [interleave(hit_ref, hit_snp)], axis=1)
        p_rows = jnp.concatenate(
            rows_scan + [interleave(rows_ref, rows_snp)], axis=1)
        return p_hit, p_rows, scan_overflow

    # ------------------------------------------------------------------
    def expand_probe_events(dix, p_is_ref, p_pos, p_flag, p_info, p_diff,
                            p_valid):
        """(NI, H) compacted probe hits -> (NI, H, 10) candidate events:
        (kmer_pos, validity)."""
        usable = p_valid & (p_pos != _POS_AMBIG)
        unamb = p_flag == 0

        # aux rows are only read for ambiguous hits (a few percent);
        # coalesce the rest onto row 0 so their gathers share one line.
        # Both dicts' tables live in one (m_r+m_s, 10, 2) array, so ONE
        # row gather yields positions and snp_info together.
        need_aux = usable & ~unamb
        aux_p = jnp.where(need_aux, p_pos, U32(0))
        m_r = dix.n_ref_aux
        m_s = dix.aux_all.shape[0] - m_r
        aux_row = jnp.where(
            p_is_ref, jnp.minimum(aux_p, U32(m_r - 1)),
            U32(m_r) + jnp.minimum(aux_p, U32(max(m_s - 1, 0))))
        aux_rows = take(dix.aux_all, aux_row.astype(I32))  # (..., 10, 2)
        aux_pos = aux_rows[..., 0]
        aux_snp = aux_rows[..., 1]

        col0 = (jnp.arange(10) == 0)
        kpos = jnp.where(unamb[..., None] & col0, p_pos[..., None], aux_pos)
        col_valid = jnp.where(unamb[..., None], col0, aux_pos != 0)

        diff_u = p_diff.astype(U32)
        live = usable[..., None] & col_valid
        # known-SNP-site suppression (qv.cc:985-993) is only consulted for
        # REF events, and live lanes are a small fraction of the (NH, 10)
        # grid: compact them before the site-bitmap word gathers. Spills
        # count into the probe-overflow stat (escalation grows NH -> CQ).
        NH10 = live.shape[0] * 10
        site_live = live & p_is_ref[..., None]
        qsrc, qovf = compact_src(site_live.reshape(-1),
                                 max(64, 2 * live.shape[0]))
        q_ok = qsrc >= 0
        qs = jnp.maximum(qsrc, 0)
        q_pos = jnp.where(q_ok, jnp.take(
            (kpos + diff_u[..., None]).reshape(-1), qs, mode="clip"),
            U32(0))
        is_site_c = search.bitmap_test(dix.site_bitmap, q_pos)
        is_site = jnp.zeros(NH10, bool).at[
            jnp.where(q_ok, qs, NH10)].set(
                is_site_c, mode="drop", unique_indices=True).reshape(
                    (live.shape[0], 10))
        snp_off = ((jnp.where(unamb[..., None] & col0,
                              p_info[..., None].astype(U32), aux_snp) >> 3)
                   & U32(0x1F)).astype(I32)
        check = jnp.where(p_is_ref[..., None], ~is_site,
                          snp_off != p_diff[..., None])
        ev_valid = usable[..., None] & col_valid & check
        return kpos, ev_valid, qovf

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def orientation_pass(dix, be, enc, qual):
        B, K, E, C, NI, H = sh.B, sh.K, sh.E, sh.C, sh.NI, sh.H
        hi, lo, kmer_valid, read_ok = enc

        if hasattr(be, "exact_both"):
            # combined tagged table: one bucket-row gather chain answers
            # both dictionaries for the whole primary grid
            (r_hit, r_pos, r_flag, s_hit, s_pos, s_info, s_flag) = \
                be.exact_both(hi, lo, kmer_valid)
        else:
            r_hit, r_pos, r_flag = be.exact_ref(hi, lo, kmer_valid)
            if cfg.sparse_exact_snp:
                x_snp0 = getattr(be, "exact_snp_sparse", be.exact_snp)
                s_hit, s_pos, s_info, s_flag = x_snp0(hi, lo, kmer_valid)
            else:
                s_hit, s_pos, s_info, s_flag = be.exact_snp(hi, lo,
                                                            kmer_valid)
        r_hit = r_hit & kmer_valid
        s_hit = s_hit & kmer_valid

        # exact hits split into the common unambiguous case (one event,
        # written directly) and the rare ambiguous case (compacted across
        # the batch BEFORE the 10-wide aux expansion -- expanding every
        # slot 10x made the event scatters the step's dominant cost)
        r_usable = r_hit & (r_pos != _POS_AMBIG)
        s_usable = s_hit & (s_pos != _POS_AMBIG)
        r_un_v = r_usable & (r_flag == 0)
        s_un_v = s_usable & (s_flag == 0)
        r_am_v = r_usable & (r_flag != 0)
        s_am_v = s_usable & (s_flag != 0)

        NA = max(64, B // 4)
        # flat order (b, k, dict) -- target slots are precomputed, so
        # compaction order never affects event order
        am_mask = jnp.stack([r_am_v, s_am_v], axis=-1).reshape(-1)
        na_src, amb_overflow = compact_src(am_mask, NA)
        na_ok = na_src >= 0
        na_s = jnp.maximum(na_src, 0)
        na_b = na_s // (K * 2)
        na_k = (na_s // 2) % K
        na_isref = (na_s % 2) == 0
        na_auxrow = jnp.where(na_isref, r_pos[na_b, na_k],
                              s_pos[na_b, na_k])
        m_r = dix.n_ref_aux
        m_s = dix.aux_all.shape[0] - m_r
        na_row = jnp.where(
            na_isref, jnp.minimum(na_auxrow, U32(m_r - 1)),
            U32(m_r) + jnp.minimum(na_auxrow, U32(max(m_s - 1, 0))))
        na_aux = take(dix.aux_all, na_row.astype(I32))[..., 0]
        na_colv = na_ok[:, None] & (na_aux != 0)
        na_count = jnp.sum(na_colv, axis=-1)                 # (NA,)

        # per-(B,K) exact event counts
        am_cnt = jnp.zeros((B, K, 2), I32).at[
            na_b, na_k, jnp.where(na_isref, 0, 1)].add(
                jnp.where(na_ok, na_count, 0), mode="drop",
                unique_indices=True)
        exr_n = r_un_v.astype(I32) + am_cnt[..., 0]
        exs_n = s_un_v.astype(I32) + am_cnt[..., 1]

        # ---- neighbor work-item compaction ----
        lowq = kmer_valid & (qual < jnp.uint8(cfg.quality_score))
        flat_mask = lowq.reshape(-1)
        item_src, ni_overflow = compact_src(flat_mask, NI)
        it_ok = item_src >= 0
        it_b = jnp.where(it_ok, item_src // K, 0)
        it_k = jnp.where(it_ok, item_src % K, 0)
        it_hi = hi[it_b, it_k]
        it_lo = lo[it_b, it_k]

        p_hit, p_rows, scan_ovf = neighbor_probes(be, dix, it_hi, it_lo,
                                                  it_ok)

        # ---- flat probe-hit compaction (NI, P2) -> (NH,) ----
        # hits are sparse; compact them across the whole batch BEFORE the
        # 10-wide aux expansion so aux gathers, site checks and event
        # scatters all run on ~real-hit-count lanes. The probe fields are
        # pre-packed as (pos, nb_hi, nb_lo, meta) rows: one 16-byte row
        # gather materializes every field of the surviving hits.
        # probe_hit_cap scales the flat hit buffer relative to NI (default
        # 32 -> 4*NI); tying NH to the config field makes probe_overflow
        # escalation (which doubles probe_hit_cap) actually grow the buffer
        NH = max(64, NI * H // 8)
        ph_flat = p_hit.reshape(-1)                  # item-major order
        ph_src, ph_overflow = compact_src(ph_flat, NH)
        h_ok = ph_src >= 0
        h_s = jnp.maximum(ph_src, 0)
        h_item = h_s // P2

        h_rows = jnp.where(h_ok[:, None],
                           jnp.take(p_rows.reshape(NI * P2, 4), h_s,
                                    axis=0), U32(0))
        h_pos = h_rows[:, 0]
        h_nbhi = h_rows[:, 1]
        h_nblo = h_rows[:, 2]
        h_meta = h_rows[:, 3]
        h_isref = (h_meta & U32(1)) != 0
        h_diff = ((h_meta >> 1) & U32(0x3F)).astype(I32)
        h_flag = ((h_meta >> 8) & U32(0xFF)).astype(jnp.uint8)
        h_info = ((h_meta >> 16) & U32(0xFF)).astype(jnp.uint8)
        h_b = it_b[h_item]
        h_k = it_k[h_item]

        if _ablate == "probes":  # profiling: stop after probe compaction
            anchor = (jnp.sum(h_pos).astype(I32) + jnp.sum(h_diff)
                      + jnp.sum(h_nbhi.astype(I32)) + jnp.sum(h_isref))
            stats = dict(ni_overflow=ni_overflow, probe_overflow=ph_overflow,
                         event_overflow=anchor,
                         cand_overflow=jnp.zeros((), I32),
                         snp_scan_overflow=scan_ovf)
            z = jnp.zeros((B, E), U32)
            buf = dict(idx=z, meta=z, k=z.astype(I32), isnb=z != 0,
                       valid=z != 0, kt=jnp.zeros((64, 3), U32))
            return dict(buf=buf, process=jnp.zeros(B, bool),
                        target=jnp.zeros(B, U32), read_ok=read_ok,
                        stats=stats)

        nb_kpos, nb_valid, site_q_ovf = expand_probe_events(
            dix, h_isref, h_pos, h_flag, h_info, h_diff, h_ok)  # (NH, 10)
        ph_overflow = ph_overflow + site_q_ovf

        # ---- event counts and group offsets ----
        nb_cnt = jnp.sum(nb_valid, axis=-1).astype(I32)      # (NH,)
        nb_n_item = jnp.zeros(NI, I32).at[h_item].add(
            jnp.where(h_ok, nb_cnt, 0), mode="drop")
        nb_n_flat = jnp.zeros(B * K, I32).at[
            jnp.where(it_ok, item_src, B * K)].set(
                nb_n_item, mode="drop", unique_indices=True)
        nb_n = nb_n_flat.reshape(B, K)
        groups = jnp.stack([exr_n, exs_n, nb_n], axis=-1).reshape(B, 3 * K)
        goff = jnp.cumsum(groups, axis=-1) - groups
        ev_total = jnp.sum(groups, axis=-1)
        ev_overflow = jnp.sum(jnp.maximum(ev_total - E, 0))
        # capacity-tuning telemetry (not overflow counters): actual maxima
        # let the bench sweep right-size E / NI / NH for the workload
        tune_stats = dict(ev_max=jnp.max(ev_total),
                          lowq_n=jnp.sum(lowq),
                          probe_hits=jnp.sum(jnp.where(h_ok, 1, 0)),
                          probe_lanes_max=jnp.sum(
                              jnp.where(h_ok, 1, 0)))

        # Event records are TWO u32 words, [idx, meta] with
        # meta = k | isnb<<5 | valid<<6 | src<<7, scattered as SEPARATE
        # flat scalar scatters into (B*(E+1),) word buffers (scalar-element
        # scatters measured far faster than row scatters on the chip this
        # engine was first tuned on; tools/bench_gather.py re-measures
        # both). Everything the pileup stage needs (kmer words,
        # mutated-base index, kmer genome position) is re-derived from
        # `meta`: kpos = idx + 32k, and (nb_hi, nb_lo, modif) come from
        # one gather of a unified source table `kt` = [per-(b, k) read
        # kmers | compacted neighbor rows], indexed by (b, k) or the meta
        # `src` field. This replaced a 5-word-record row scatter that was
        # the step's dominant cost.
        NEV = B * (E + 1)
        ev_idx_f = jnp.zeros(NEV, U32)
        ev_meta_f = jnp.zeros(NEV, U32)

        def meta_of(kslot, is_nb, src=None):
            m = (kslot.astype(U32)
                 | (U32(1 << 5) if is_nb else U32(0))
                 | U32(1 << 6))
            if src is not None:
                m = m | (src.astype(U32) << 7)
            return m

        # exact unambiguous: one event at its group's base slot; ref and
        # snp hits are DENSE on real workloads (primary k-mers exist in
        # the genome; SNP-adjacent k-mers hit the snp dict at SNP-density
        # rate), so both ride ONE direct scatter over (B, 2K) lanes
        rows_b2 = jnp.arange(B)[:, None]
        kslot_arr = jnp.broadcast_to(jnp.arange(K, dtype=I32)[None, :],
                                     (B, K))
        g_exr = goff[:, 0::3]                                  # (B, K)
        g_exs = goff[:, 1::3]
        base2 = rows_b2 * (E + 1)
        t_r = jnp.where(r_un_v & (g_exr < E), base2 + g_exr, NEV)
        t_s = jnp.where(s_un_v & (g_exs < E), base2 + g_exs, NEV)
        t_rs = jnp.concatenate([t_r, t_s], axis=1).reshape(-1)  # (B*2K,)
        i_rs = jnp.concatenate(
            [r_pos - (kslot_arr * 32).astype(U32),
             s_pos - (kslot_arr * 32).astype(U32)], axis=1).reshape(-1)
        m_ex = jnp.broadcast_to(meta_of(kslot_arr, False), (B, K))
        m_rs = jnp.concatenate([m_ex, m_ex], axis=1).reshape(-1)
        ev_idx_f = ev_idx_f.at[t_rs].set(i_rs, mode="drop",
                                         unique_indices=True)
        ev_meta_f = ev_meta_f.at[t_rs].set(m_rs, mode="drop",
                                           unique_indices=True)

        # exact ambiguous: aux events are a few % of the (NA, 10) grid;
        # compact them (one cheap device sort) so the scatter runs on
        # ~real-event lanes instead of the whole grid
        na_g = goff[na_b, 3 * na_k + jnp.where(na_isref, 0, 1)]  # (NA,)
        na_rank = jnp.cumsum(na_colv, axis=-1) - 1
        e_a = na_g[:, None] + na_rank
        t_a = jnp.where(na_colv & (e_a < E),
                        na_b[:, None] * (E + 1) + e_a, NEV)
        NAX = max(64, 4 * NA)   # >= max aux events (10 per aux item); the
        # spill counts into amb_overflow, whose escalation doubles NA
        i_a = na_aux - (na_k[:, None] * 32).astype(U32)
        m_a = jnp.broadcast_to(meta_of(na_k[:, None], False), i_a.shape)
        fa_rows = jnp.stack(
            [i_a.reshape(-1), m_a.reshape(-1),
             t_a.reshape(-1).astype(U32)], axis=1)
        ax_src, ax_ovf = compact_src((t_a < NEV).reshape(-1), NAX)
        amb_overflow = amb_overflow + ax_ovf
        ax_ok = ax_src >= 0
        ax_rows = jnp.where(ax_ok[:, None],
                            jnp.take(fa_rows, jnp.maximum(ax_src, 0),
                                     axis=0), U32(0))
        ax_t = jnp.where(ax_ok, ax_rows[:, 2].astype(I32), NEV)
        ev_idx_f = ev_idx_f.at[ax_t].set(ax_rows[:, 0], mode="drop",
                                         unique_indices=True)
        ev_meta_f = ev_meta_f.at[ax_t].set(ax_rows[:, 1], mode="drop",
                                           unique_indices=True)

        # neighbor events: (NH, 10); order within an item = (probe, col);
        # within-item base = global exclusive cumsum minus the item's start
        C_ex = cumsum_mask(nb_cnt) - nb_cnt                    # (NH,)
        item_base = cumsum_mask(nb_n_item) - nb_n_item          # (NI,)
        within = C_ex - item_base[h_item]
        nb_g = goff[h_b, 3 * h_k + 2]
        col_rank = jnp.cumsum(nb_valid, axis=-1) - 1
        e_nb = (nb_g + within)[:, None] + col_rank
        e_nb = jnp.where(nb_valid & (e_nb < E), e_nb, E + 1)

        # neighbor events are genuinely sparse (hits are a few % of the
        # (NH, 10) aux grid); compact them across the batch, keep their
        # wide fields (kmer words, mutated base) in the compacted side
        # table, and scatter only the 2-word records
        NSE = max(64, int(B * (E + 1) * cfg.sparse_events_frac))
        f_e = e_nb.reshape(-1)
        f_b = jnp.broadcast_to(h_b[:, None], e_nb.shape).reshape(-1)
        f_t = jnp.where(f_e < E, f_b * (E + 1) + f_e, NEV)
        # rows carry every field + target so ONE gather materializes them
        f_w6 = jnp.stack(
            [nb_kpos.reshape(-1),
             jnp.broadcast_to(h_k[:, None], e_nb.shape).reshape(-1)
             .astype(U32),
             jnp.broadcast_to(h_nbhi[:, None], e_nb.shape).reshape(-1),
             jnp.broadcast_to(h_nblo[:, None], e_nb.shape).reshape(-1),
             jnp.broadcast_to(h_diff[:, None], e_nb.shape).reshape(-1)
             .astype(U32),
             f_t.astype(U32)], axis=1)
        se_m = f_e < E
        se_src, sev_overflow = compact_src(se_m, NSE)
        se_ok = se_src >= 0
        se_rows = jnp.where(se_ok[:, None],
                            jnp.take(f_w6, jnp.maximum(se_src, 0),
                                     axis=0), U32(0))
        se_t = jnp.where(se_ok, se_rows[:, 5].astype(I32), NEV)
        se_k = se_rows[:, 1]
        ev_idx_f = ev_idx_f.at[se_t].set(se_rows[:, 0] - se_k * U32(32),
                                         mode="drop", unique_indices=True)
        ev_meta_f = ev_meta_f.at[se_t].set(
            se_k | U32(1 << 5) | U32(1 << 6)
            | (jnp.arange(NSE, dtype=U32) << 7),
            mode="drop", unique_indices=True)

        # unified pileup source table: row b*K+k = the read kmer at slot k
        # (no mutation); row B*K+j = compacted neighbor row j's mutated
        # kmer + mutated-base index
        kt = jnp.concatenate([
            jnp.stack([hi.reshape(-1), lo.reshape(-1),
                       jnp.full(B * K, _NO_MOD, U32)], axis=-1),
            jnp.stack([se_rows[:, 2], se_rows[:, 3],
                       jnp.where(se_ok, se_rows[:, 4], U32(_NO_MOD))],
                      axis=-1)], axis=0)

        pk_idx = ev_idx_f.reshape(B, E + 1)[:, :E]
        meta = ev_meta_f.reshape(B, E + 1)[:, :E]
        buf = dict(
            idx=pk_idx,
            meta=meta,
            k=(meta & U32(0x1F)).astype(I32),
            isnb=(meta & U32(1 << 5)) != 0,
            valid=(meta & U32(1 << 6)) != 0,
            kt=kt,
        )

        if _ablate in ("no_vote", "events"):
            stats = dict(ni_overflow=ni_overflow, probe_overflow=ph_overflow,
                         event_overflow=ev_overflow,
                         sev_overflow=sev_overflow,
                         cand_overflow=jnp.zeros((), I32),
                         snp_scan_overflow=scan_ovf)
            return dict(buf=buf, process=jnp.zeros(B, bool),
                        target=jnp.zeros(B, U32), read_ok=read_ok,
                        stats=stats)

        # ---- vote scan (improved_index_table_add, qv.cc:132-178) ----
        process, target, cand_ovf = vote_scan(
            *(jnp.moveaxis(buf[f], 1, 0)
              for f in ("idx", "k", "isnb", "valid")), C)

        stats = dict(ni_overflow=ni_overflow, probe_overflow=ph_overflow,
                     event_overflow=ev_overflow, sev_overflow=sev_overflow,
                     cand_overflow=cand_ovf,
                     snp_scan_overflow=scan_ovf, **tune_stats)
        return dict(buf=buf, process=process, target=target,
                    read_ok=read_ok, stats=stats)

    # ------------------------------------------------------------------
    def pileup_accumulate(dix, buf, use_mask, target, ref_cnt, alt_cnt):
        """Scatter agreeing contexts into per-site counts
        (qv.cc:1382-1502).

        Agreeing contexts are compacted across the WHOLE batch into a flat
        (FA,) buffer with gathers (the per-read (B, A) scatter-compaction
        this replaces was the step's dominant cost: 5 scatter ops over
        B*E lanes). Counts are order-independent saturating sums, so batch-
        flat processing is exact. FA = B * agree_cap (agree_cap is the
        average agreeing contexts per read, escalated on overflow)."""
        B, E = sh.B, sh.E
        FA = max(64, B * sh.A)
        n_sites = dix.site_pos.shape[0]
        nwords = dix.site_dir.shape[0]

        agree = (buf["valid"] & use_mask[:, None]
                 & (buf["idx"] == target[:, None])).reshape(-1)
        agree_n = jnp.sum(agree, dtype=I32)   # capacity-tuning telemetry
        src_idx, agree_ovf = compact_src(agree, FA)
        f_ok = src_idx >= 0
        s = jnp.maximum(src_idx, 0)

        # two word gathers materialize the 2-word event records of the
        # agreeing contexts; the wide fields (kmer words, mutated-base
        # index) come from ONE row gather of the unified source table
        # buf["kt"] (read kmers by (b, k); neighbor rows by meta src)
        a_idx = jnp.where(f_ok, jnp.take(buf["idx"].reshape(-1), s,
                                         mode="clip"), U32(0))
        K = sh.K
        a_meta = jnp.where(f_ok, jnp.take(buf["meta"].reshape(-1), s,
                                          mode="clip"), U32(0))
        a_k = (a_meta & U32(0x1F)).astype(I32)
        a_isnb = f_ok & ((a_meta & U32(1 << 5)) != 0)
        a_src = (a_meta >> 7).astype(I32)
        a_b = s // E
        a_kpos = a_idx + (a_k * 32).astype(U32)
        kt_row = jnp.where(a_isnb, B * K + a_src, a_b * K + a_k)
        ktr = jnp.where(f_ok[:, None], take(buf["kt"], kt_row), U32(0))
        a_nbhi = ktr[:, 0]
        a_nblo = ktr[:, 1]
        a_modif = jnp.where(f_ok, ktr[:, 2].astype(I32), _NO_MOD)

        # A context covers 32 CONSECUTIVE genome positions, so its site
        # membership lives in just two bitmap words: fetch [bitmap, rank]
        # for both words once per context (2 small gathers), then derive
        # per-base membership and site ids with pure vector math.
        w0 = (a_kpos >> 5).astype(I32)                        # (FA,)
        off = (a_kpos & U32(31)).astype(I32)
        d = take(dix.site_dir, jnp.minimum(w0, nwords - 1))  # (FA, 4)
        bm0, rk0 = d[..., 0], d[..., 1].astype(I32)
        bm1, rk1 = d[..., 2], d[..., 3].astype(I32)
        bm0 = jnp.where(w0 < nwords, bm0, U32(0))
        bm1 = jnp.where((w0 + 1) < nwords, bm1, U32(0))

        # The context's 32-base site membership is ONE 32-bit mask built
        # from the two bitmap words; sites are then extracted by repeated
        # lowest-set-bit clearing into S slots per context (pure vector
        # bit math). This replaces the (FA, 32) per-base grid, whose
        # 4M-lane compaction scatter was the step's single largest fusion
        # in an earlier device trace.
        offu = off.astype(U32)
        m = jnp.where(f_ok,
                      (bm0 >> offu)
                      | jnp.where(off > 0, bm1 << (U32(32) - offu), U32(0)),
                      U32(0))
        # exclude the mutated base (qv.cc:1470: skip modified_pos)
        m = m & ~jnp.where(a_modif < 32,
                           U32(1) << jnp.clip(a_modif, 0, 31).astype(U32),
                           U32(0))

        S = sh.SC   # site slots per context (sites_per_context, escalated)
        e_i = []
        e_ok = []
        mm = m
        for _ in range(S):
            lb = mm & (~mm + U32(1))            # lowest set bit
            e_ok.append(lb != 0)
            e_i.append(jax.lax.population_count(lb - U32(1)).astype(I32))
            mm = mm & (mm - U32(1))             # clear it
        slot_ovf = jnp.sum(jax.lax.population_count(mm).astype(I32))
        # (windows with >S sites escalate sites_per_context)
        x_i = jnp.stack(e_i, axis=1)            # (FA, S) base index
        x_ok = jnp.stack(e_ok, axis=1)

        # site id of each extracted bit: rank directory + popcount of the
        # word's lower bits (word chosen by absolute offset)
        oi = off[:, None] + x_i                 # (FA, S)
        in_w1 = oi >= 32
        bit = (oi & 31).astype(U32)
        bm = jnp.where(in_w1, bm1[:, None], bm0[:, None])
        rk = jnp.where(in_w1, rk1[:, None], rk0[:, None])
        low_mask = (U32(1) << bit) - U32(1)
        src = rk + jax.lax.population_count(bm & low_mask).astype(I32)
        src = jnp.minimum(src, max(n_sites - 1, 0))

        # flat compaction of extracted hits, then one gather + scatter-add
        FG = FA // 2
        fh = x_ok.reshape(-1)
        gs, site_ovf = compact_src(fh, FG)
        g_ok = gs >= 0
        g = jnp.maximum(gs, 0)
        g_src = jnp.where(g_ok, src.reshape(-1)[g], 0)
        g_ctx = g // S
        g_i = x_i.reshape(-1)[g]
        g_base = _get_base(a_nbhi[g_ctx], a_nblo[g_ctx], g_i)

        ra = take(dix.site_ra, g_src)
        sref = (ra & U32(0xFF)).astype(jnp.uint8)
        salt = ((ra >> 8) & U32(0xFF)).astype(jnp.uint8)
        add_ref = g_ok & (g_base == sref)
        add_alt = g_ok & ~add_ref & (g_base == salt)
        dump = jnp.int32(n_sites)
        tgt_row = jnp.where(g_ok, g_src, dump)
        ref_cnt = ref_cnt.at[tgt_row].add(add_ref.astype(I32), mode="drop")
        alt_cnt = alt_cnt.at[tgt_row].add(add_alt.astype(I32), mode="drop")
        return ref_cnt, alt_cnt, agree_ovf + site_ovf, slot_ovf, agree_n

    # ------------------------------------------------------------------
    def step(dix_t, codes, n_kmers, qual, ref_cnt, alt_cnt):
        be = backend_factory(dix_t)
        enc = encode_batch(codes, n_kmers, sh.K)
        return _finish_dual(dix_t, be, enc, n_kmers, qual, ref_cnt, alt_cnt)

    def step_enc(dix_t, hi, lo, kvalid, read_ok, n_kmers, qual, ref_cnt,
                 alt_cnt):
        """Dual-orientation step from host-pre-encoded kmer words (the
        mesh data-parallel runner ships these instead of base codes)."""
        be = backend_factory(dix_t)
        return _finish_dual(dix_t, be, (hi, lo, kvalid, read_ok), n_kmers,
                            qual, ref_cnt, alt_cnt)

    def _finish_dual(dix_t, be, enc, n_kmers, qual, ref_cnt, alt_cnt):
        fwd = orientation_pass(dix_t, be, enc, qual)

        # reverse-complement retry for unprocessed reads (qv.cc:1504-1510),
        # derived from the packed words (no device re-encode)
        rev = orientation_pass(dix_t, be, rc_enc(*enc, n_kmers, sh.K), qual)

        use_fwd = fwd["process"]
        use_rev = ~fwd["process"] & fwd["read_ok"] & rev["process"]

        if _ablate == "no_pileup":
            aovf1 = aovf2 = sovf1 = sovf2 = jnp.zeros((), I32)
            an1 = an2 = jnp.zeros((), I32)
        else:
            ref_cnt, alt_cnt, aovf1, sovf1, an1 = pileup_accumulate(
                dix_t, fwd["buf"], use_fwd, fwd["target"], ref_cnt, alt_cnt)
            ref_cnt, alt_cnt, aovf2, sovf2, an2 = pileup_accumulate(
                dix_t, rev["buf"], use_rev, rev["target"], ref_cnt, alt_cnt)

        stats = {("fwd_" + k): v for k, v in fwd["stats"].items()}
        stats.update({("rev_" + k): v for k, v in rev["stats"].items()})
        stats["agree_overflow"] = aovf1 + aovf2
        stats["site_slot_overflow"] = sovf1 + sovf2
        stats["agree_lanes_max"] = jnp.maximum(an1, an2)
        stats["n_processed"] = jnp.sum(use_fwd | use_rev)
        rovf = getattr(be, "route_overflow", None)
        if rovf is not None:
            stats["route_overflow"] = rovf
        sovf = getattr(be, "sparse_overflow", None)
        if sovf is not None:
            stats["sparse_overflow"] = sovf
        aovf_b = getattr(be, "act_overflow", None)
        if aovf_b is not None:
            stats["act_overflow"] = aovf_b
        _lane_telemetry(be, stats)
        if return_debug:
            debug = dict(
                fwd_process=fwd["process"], fwd_target=fwd["target"],
                rev_process=rev["process"], rev_target=rev["target"],
                use_fwd=use_fwd, use_rev=use_rev)
            return ref_cnt, alt_cnt, stats, debug
        return ref_cnt, alt_cnt, stats

    # ------------------------------------------------------------------
    def step_single(dix_t, codes, n_kmers, qual, ref_cnt, alt_cnt):
        """One orientation only: pileup for processed reads, and report
        (process, read_ok) so the host can queue reverse-complement retries
        (reference: only failed forward reads are reprocessed,
        qv.cc:1504-1510). Reverse batches are fed as pre-complemented codes.
        """
        be = backend_factory(dix_t)
        enc = encode_batch(codes, n_kmers, sh.K)
        res = orientation_pass(dix_t, be, enc, qual)
        return _finish_single(dix_t, be, res, enc[2][:, 0], ref_cnt,
                              alt_cnt)

    def step_single_enc(dix_t, hi, lo, kvalid, read_ok, qual, ref_cnt,
                        alt_cnt):
        """Pre-encoded variant of step_single: the host ships packed
        (hi, lo) kmer words + validity (native.encode_batch) instead of
        (B, L) base codes -- ~3.6x less transfer per dispatch."""
        be = backend_factory(dix_t)
        res = orientation_pass(dix_t, be, (hi, lo, kvalid, read_ok), qual)
        return _finish_single(dix_t, be, res, kvalid[:, 0], ref_cnt,
                              alt_cnt)

    def _finish_single(dix_t, be, res, kv0, ref_cnt, alt_cnt):
        ref_cnt, alt_cnt, aovf, sovf, agree_n = pileup_accumulate(
            dix_t, res["buf"], res["process"], res["target"], ref_cnt,
            alt_cnt)
        stats = dict(res["stats"])
        stats["agree_overflow"] = aovf
        stats["site_slot_overflow"] = sovf
        stats["agree_lanes_max"] = agree_n
        stats["n_processed"] = jnp.sum(res["process"])
        # reads this orientation failed that are retry-eligible (the host's
        # reverse-complement queueing predicate, kv0 = (nk>0) & read_ok):
        # multi-host runners read this PER-DEVICE stat from the replicated
        # stats rows to schedule lockstep retry batches with no extra
        # communication (dist.multihost)
        stats["retry_n"] = jnp.sum(~res["process"] & res["read_ok"] & kv0,
                                   dtype=I32)
        rovf = getattr(be, "route_overflow", None)
        if rovf is not None:
            stats["route_overflow"] = rovf
        sovf = getattr(be, "sparse_overflow", None)
        if sovf is not None:
            stats["sparse_overflow"] = sovf
        aovf_b = getattr(be, "act_overflow", None)
        if aovf_b is not None:
            stats["act_overflow"] = aovf_b
        _lane_telemetry(be, stats)
        return (ref_cnt, alt_cnt, res["process"], res["read_ok"], stats)

    def step_multi_enc(dix_t, hi, lo, kvalid, read_ok, qual, ref_cnt,
                       alt_cnt):
        """Grouped dispatch: scan G pre-encoded sub-batches inside ONE
        jitted call, so a high-latency dispatch link pays one round trip
        (args transfer, program launch, stats readback) per G batches
        instead of per batch. Inputs are (G, B, ...) stacks; counts
        accumulate across the scan exactly as G sequential steps would."""

        def body(carry, x):
            rc, ac = carry
            h, l, kv, rok, q = x
            rc, ac, process, rok2, stats = step_single_enc(
                dix_t, h, l, kv, rok, q, rc, ac)
            return (rc, ac), (process, rok2, stats)

        (rc, ac), (proc, rok_o, stats) = jax.lax.scan(
            body, (ref_cnt, alt_cnt), (hi, lo, kvalid, read_ok, qual))
        stats = {k: (jnp.max(v) if k.endswith("_max") else jnp.sum(v))
                 for k, v in stats.items()}
        return rc, ac, proc, rok_o, stats

    # accumulators are NOT donated: GenoRunner chains its running totals
    # straight through the step (zero per-batch zeros/merge dispatches),
    # and the rare overflow escalation REWINDS to a batch's input totals,
    # which donation would have destroyed (see GenoRunner._finalize_batch)
    jitted = jax.jit(step)
    jitted_single = jax.jit(step_single)
    jitted_single_enc = jax.jit(step_single_enc)
    jitted_multi_enc = jax.jit(step_multi_enc)

    def run(codes, n_kmers, qual, ref_cnt, alt_cnt):
        return jitted(host_dix, codes, n_kmers, qual, ref_cnt, alt_cnt)

    def run_single(codes, n_kmers, qual, ref_cnt, alt_cnt):
        return jitted_single(host_dix, codes, n_kmers, qual, ref_cnt,
                             alt_cnt)

    def run_single_enc(hi, lo, kvalid, read_ok, qual, ref_cnt, alt_cnt):
        return jitted_single_enc(host_dix, hi, lo, kvalid, read_ok, qual,
                                 ref_cnt, alt_cnt)

    def run_multi_enc(hi, lo, kvalid, read_ok, qual, ref_cnt, alt_cnt):
        return jitted_multi_enc(host_dix, hi, lo, kvalid, read_ok, qual,
                                ref_cnt, alt_cnt)

    run.raw = step          # unjitted (dix, codes, ...) for shard_map use
    run.raw_enc = step_enc  # unjitted pre-encoded dual variant
    run.single = run_single
    run.single_enc = run_single_enc
    run.multi_enc = run_multi_enc
    run.raw_single = step_single
    run.raw_single_enc = step_single_enc  # unjitted, for shard_map wrappers
    run.raw_multi_enc = step_multi_enc
    run.shapes = sh
    return run
