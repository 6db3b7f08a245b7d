"""Device-resident index: every dictionary/Bloom/site array as jnp tensors.

K-mers are (hi, lo) uint32 pairs (the device path keeps 32-bit lanes; see
core.kmer). Dictionaries stay sorted by the u64 key, i.e. by (hi, lo)
lexicographically; jumpgates are unnecessary on the device -- block bounds
come from
binary search over the same sorted arrays (replacing the reference's 16 GiB
2^32-entry jumpgate, src/qv.cc:528-584, with O(log n) searches).

The Bloom filters are bit-packed uint32 words (LSB-first), identical bit
positions to the reference's sdsl bit_vectors.

``site_bitmap`` is a genome-positions bitmap used for the O(1) neighbor
suppression check (pileup_table[pos].ref/alt != 0, src/qv.cc:990-992);
``site_pos`` + per-site arrays drive the final scatter/call stage.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..index.store import VarGenoIndex


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DeviceIndex:
    # ref dictionary. Row metadata is packed (pos, flag) so a block scan
    # fetches both with ONE 8-byte row gather instead of two 4/1-byte
    # gathers (XLA emits one gather op per array; packing halves the
    # scan-stage gather count).
    ref_hi: jax.Array      # (n//32, 32) u32 on device (the block-bounds
                           # window gather consumes 32-value rows; storing
                           # the tiled 2D form avoids a full-table relayout
                           # copy inside every step); (n,) u32 when built
                           # host_only (sharded mode shards the flat form)
    ref_lo: jax.Array      # (n,) u32
    ref_meta: jax.Array    # (n, 2) u32 [pos, flag]
    aux_all: jax.Array     # (m_r + m_s, 10, 2) u32 [pos, snp_info]: both
                           # dicts' ambiguity tables in one array (snp rows
                           # offset by n_ref_aux) -> one row gather per
                           # ambiguous hit instead of three
    # snp dictionary: same packing; scans additionally test (lo, hi8)
    # at stride-bug indices, so those live in one packed row array too
    snp_hi: jax.Array
    snp_lo: jax.Array
    snp_meta: jax.Array    # (n, 2) u32 [pos, flag | info<<8]
    snp_test: jax.Array    # (n, 2) u32 [lo, hi & 0xFF]
    # Bloom filters (u32 words, LSB-first)
    ref_bf: jax.Array
    snp_bf: jax.Array
    # SNP sites (sorted by position)
    site_pos: jax.Array    # (s,) u32
    site_ref: jax.Array    # (s,) u8
    site_alt: jax.Array    # (s,) u8
    site_bitmap: jax.Array  # (ceil((max_pos+33)/32),) u32
    site_rank: jax.Array   # (nwords,) i32: # of site bits before each word
    # (succinct rank directory: site_id(pos) = site_rank[pos>>5] +
    #  popcount(bitmap[pos>>5] & low_mask), replacing binary search in the
    #  pileup scatter -- the device analog of sdsl's rank_support_v)
    site_dir: jax.Array    # (nwords, 4) u32 [bm, rank, bm_next, rank_next]:
                           # a 32-base context spans <=2 words; pairing each
                           # word with its successor makes that ONE gather
    site_ra: jax.Array     # (s,) u32 ref | alt<<8: one-gather allele pair
    # ONE bucketized hash table answers exact lookups in BOTH dictionaries
    # (engine.hashtable): ref and snp rows share buckets, tagged in flag
    # bit 7, so a probe pays one bucket-row gather for two answers
    both_ht: jax.Array     # (nb, 32) u32
    # full-key membership prefilter over the union of both key sets
    # (engine.hashtable.prefilter_*): sparse probe sets test one bit
    # before paying the bucket-chain gathers
    both_pf: jax.Array     # (pf_bits/32,) u32
    # block jumpgates: prefix-count arrays over the top 24 key bits.
    # snp blocks ARE hi24 blocks (reference 2^24 jumpgate, qv.cc:615), so
    # snp_jg[h24] / snp_jg[h24+1] give exact bounds in two 4-byte gathers.
    # ref blocks are hi32-keyed (reference 16 GiB 2^32 jumpgate,
    # qv.cc:528-584); ref_jg narrows to the hi24 block and one aligned
    # ref_win_rows x 128 B window gather over ref_hi (padded to a 32-row
    # multiple so the (n/32, 32) reshape is free) resolves the exact hi32
    # sub-block -- same gather bytes as a bucket probe, no 4.3 GB directory
    ref_jg: jax.Array      # (2^24 + 1,) u32
    snp_jg: jax.Array      # (2^24 + 1,) u32
    # static metadata
    snp_bf_bits: int = dataclasses.field(metadata=dict(static=True))
    ref_bf_bits: int = dataclasses.field(metadata=dict(static=True))
    n_ref_aux: int = dataclasses.field(metadata=dict(static=True))
    both_ht_nb: int = dataclasses.field(metadata=dict(static=True))
    both_ht_chain: int = dataclasses.field(metadata=dict(static=True))
    both_pf_bits: int = dataclasses.field(metadata=dict(static=True))
    # rows of 32 ref_hi values a hi32 block-bounds query must gather to
    # cover the largest hi24 block (build-time measured)
    ref_win_rows: int = dataclasses.field(metadata=dict(static=True))
    # largest ref hi32 block / snp hi24 block (rows).  The small-block
    # Hamming scans never see a block bigger than these, so scan width
    # shrinks from the 100-slot worst case to the data's actual bound
    # (typically <16), cutting scan-stage gather traffic accordingly.
    ref_scan_max: int = dataclasses.field(metadata=dict(static=True))
    snp_scan_max: int = dataclasses.field(metadata=dict(static=True))
    # true (pre-padding) dictionary row counts; the dict arrays themselves
    # are zero-padded to a 32-row multiple (see build_device_index.pad32)
    n_ref_rows: int = dataclasses.field(metadata=dict(static=True))
    n_snp_rows: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_ref(self) -> int:
        return self.n_ref_rows

    @property
    def n_snp(self) -> int:
        return self.n_snp_rows

    @property
    def n_sites(self) -> int:
        return self.site_pos.shape[0]


def max_run(sorted_keys, chunk: int = 1 << 26):
    """Longest run of equal values in a sorted array, computed in chunks
    (flatnonzero over a whole-genome key array allocates 8 B/unique-key
    of temporaries)."""
    n = sorted_keys.shape[0]
    if n == 0:
        return 1
    best = 1
    carry = 1
    for s in range(0, n, chunk):
        seg = sorted_keys[max(s - 1, 0):min(s + chunk, n)]
        neq = seg[1:] != seg[:-1]
        b = np.flatnonzero(neq)
        if b.size == 0:
            carry += seg.shape[0] - 1
            best = max(best, carry)
            continue
        carry += int(b[0])
        best = max(best, carry)
        if b.size > 1:
            best = max(best, int(np.diff(b).max()))
        carry = seg.shape[0] - 1 - int(b[-1])
    return max(best, carry, 1)


_DERIVED_VERSION = 5  # bump when table layouts / hash family change
                      # (v5: field-blocked bucket rows)


class _DerivedCache:
    """Disk cache for the expensive derived device tables (bucketized hash
    tables, prefilter bitmaps) inside ``<prefix>.vgt/derived/``. Building
    them takes minutes at 10^8-key scale; mmap-loading is ~free. The cache
    keys on row counts + layout version and is wiped by store.save_dir when
    an index is rebuilt at the same prefix."""

    def __init__(self, index, n_ref: int, n_snp: int):
        import os

        self.dir = None
        self.meta = None
        prefix = getattr(index, "prefix", None)
        if prefix and os.path.isdir(prefix + ".vgt"):
            self.dir = os.path.join(prefix + ".vgt", "derived")
        self._key = dict(version=_DERIVED_VERSION, n_ref=n_ref, n_snp=n_snp)
        if self.dir and os.path.exists(os.path.join(self.dir, "meta.json")):
            import json

            try:
                with open(os.path.join(self.dir, "meta.json")) as f:
                    m = json.load(f)
                if all(m.get(k) == v for k, v in self._key.items()):
                    self.meta = m
            except (OSError, ValueError):
                pass

    def has(self, *names: str) -> bool:
        """All artifacts present. Array files count only when the CURRENT
        meta records writing them ("files_<name>") -- a bare .npy on disk
        may be left over from an older layout version (observed: a stale
        4.3 GB v3 table alongside fresh v4 meta)."""
        if self.meta is None:
            return False
        for n in names:
            if n not in self.meta and not self.meta.get("files_" + n):
                return False
        return True

    def load(self, name: str) -> np.ndarray:
        import os

        return np.load(os.path.join(self.dir, name + ".npy"), mmap_mode="r")

    def save(self, meta: dict | None = None, **arrays) -> None:
        """Best-effort incremental save; meta fields merge across calls."""
        if self.dir is None:
            return
        import json
        import os

        try:
            os.makedirs(self.dir, exist_ok=True)
            for name, arr in arrays.items():
                tmp = os.path.join(self.dir, name + ".npy.tmp")
                with open(tmp, "wb") as f:
                    np.save(f, np.ascontiguousarray(arr))
                os.replace(tmp, os.path.join(self.dir, name + ".npy"))
            m = dict(self.meta) if self.meta is not None else dict(self._key)
            for name in arrays:
                m["files_" + name] = True
            if meta:
                m.update(meta)
            tmp = os.path.join(self.dir, "meta.json.tmp")
            with open(tmp, "w") as f:
                json.dump(m, f)
            os.replace(tmp, os.path.join(self.dir, "meta.json"))
            self.meta = m
        except OSError:
            pass  # cache is best-effort (read-only index dir, disk full)


def build_device_index(index: VarGenoIndex,
                       skip_tables: bool = False,
                       host_only: bool = False,
                       ht_target_load: float = 0.5) -> DeviceIndex:
    """skip_tables: omit the exact-lookup hash tables and prefilters
    (1-row dummies). Sharded-dictionary mode answers exact lookups by
    binary search over the shard arrays, so building the replicated
    tables -- 50+ B/key -- would waste host RAM at whole-genome scale.
    host_only: keep arrays as numpy (callers that re-partition them, e.g.
    dist.sharded_dict.partition_index, avoid a device round trip).
    ht_target_load: combined-table bucket load factor. 0.5 (default)
    yields probe chain 2 on most indexes (one full bucket anywhere forces
    a second row gather for EVERY query lane); 0.20-0.25 doubles the
    table bytes but makes chain 1, halving the exact-lookup gather -- the
    single largest op in the device step profile."""
    ref_k = index.ref.kmers
    snp_k = index.snp.kmers
    sites = index.sites

    max_pos = int(index.ref.pos[index.ref.flag == 0].max(initial=0))
    if sites.pos.size:
        max_pos = max(max_pos, int(sites.pos.max()))
    nbits = max_pos + 33
    bitmap = np.zeros((nbits + 31) // 32, np.uint32)
    # only sites with ref != alt suppress (ref==0 && alt==0 is "no snp");
    # seeded sites always have ref != alt, so every site sets its bit
    sp = sites.pos.astype(np.int64)
    np.bitwise_or.at(bitmap, sp >> 5,
                     (np.uint32(1) << (sp & 31).astype(np.uint32)))
    pc = np.bitwise_count(bitmap).astype(np.int64)
    site_rank = np.concatenate([[0], np.cumsum(pc)[:-1]]).astype(np.int32)
    site_dir2 = np.stack([bitmap, site_rank.view(np.uint32)], axis=1)
    # pair each word with its successor (last row's successor half is
    # [0, 0]; the engine masks out-of-range words anyway)
    site_dir = np.concatenate(
        [site_dir2, np.concatenate([site_dir2[1:],
                                    np.zeros((1, 2), np.uint32)])], axis=1)

    def u32pair(k):
        return ((k >> np.uint64(32)).astype(np.uint32),
                (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    ref_hi, ref_lo = u32pair(ref_k)
    snp_hi, snp_lo = u32pair(snp_k)

    # The engine gathers from these arrays unconditionally; give empty
    # dictionaries one sentinel row (kmer 0xFF..FF, pos=POS_AMBIGUOUS) that
    # can never produce an event, and empty aux tables a zero row.
    def pad1(a, fill):
        if a.shape[0] == 0:
            return np.full((1,) + a.shape[1:], fill, a.dtype)
        return a

    ref_pos_a, ref_flag_a, ref_aux_a = index.ref.pos, index.ref.flag, \
        index.ref.aux
    snp_pos_a, snp_info_a, snp_flag_a = (index.snp.pos, index.snp.snp,
                                         index.snp.flag)
    snp_aux_pos_a, snp_aux_snp_a = index.snp.aux_pos, index.snp.aux_snp
    if ref_hi.shape[0] == 0:
        ref_hi = pad1(ref_hi, 0xFFFFFFFF)
        ref_lo = pad1(ref_lo, 0xFFFFFFFF)
        ref_pos_a = pad1(ref_pos_a, 0xFFFFFFFF)
        ref_flag_a = pad1(ref_flag_a, 1)
    if snp_hi.shape[0] == 0:
        snp_hi = pad1(snp_hi, 0xFFFFFFFF)
        snp_lo = pad1(snp_lo, 0xFFFFFFFF)
        snp_pos_a = pad1(snp_pos_a, 0xFFFFFFFF)
        snp_info_a = pad1(snp_info_a, 0)
        snp_flag_a = pad1(snp_flag_a, 1)
    ref_aux_a = pad1(ref_aux_a, 0)
    snp_aux_pos_a = pad1(snp_aux_pos_a, 0)
    snp_aux_snp_a = pad1(snp_aux_snp_a, 0)
    site_pos_a = pad1(sites.pos, 0xFFFFFFFF)
    site_ref_a = pad1(sites.ref, 0)
    site_alt_a = pad1(sites.alt, 0)
    site_ra = (site_ref_a.astype(np.uint32)
               | (site_alt_a.astype(np.uint32) << np.uint32(8)))

    from .hashtable import HostHashTable, build_hash_table

    cache = _DerivedCache(index, n_ref=int(ref_hi.shape[0]),
                          n_snp=int(snp_hi.shape[0]))
    # cache the combined table PER load factor: different entry points
    # build at different loads (bench at 0.24, default runners at 0.5), and
    # a single slot would rebuild + overwrite on every alternation
    tag = ("%g" % ht_target_load).replace(".", "p")
    ht_name = f"both_ht_{tag}"
    if skip_tables:
        dummy = np.zeros((1, 32), np.uint32)
        both_tab = HostHashTable(table=dummy, nb=1, chain=1)
    elif cache.has(ht_name, f"both_nb_{tag}", f"both_chain_{tag}"):
        both_tab = HostHashTable(table=cache.load(ht_name),
                                 nb=cache.meta[f"both_nb_{tag}"],
                                 chain=cache.meta[f"both_chain_{tag}"])
    elif (cache.has("both_ht", "both_nb", "both_chain")
          and cache.meta.get("both_load", 0.5) == ht_target_load):
        # legacy single-slot entry from older builds
        both_tab = HostHashTable(table=cache.load("both_ht"),
                                 nb=cache.meta["both_nb"],
                                 chain=cache.meta["both_chain"])
    else:
        # one table holds both dictionaries: snp rows carry tag bit 7 in
        # the flag byte (reference flags use bit 0 only), so one bucket
        # probe answers exact lookups in BOTH dicts
        both_tab = build_hash_table(
            np.concatenate([ref_hi, snp_hi]),
            np.concatenate([ref_lo, snp_lo]),
            np.concatenate([ref_pos_a, snp_pos_a]),
            np.concatenate([ref_flag_a,
                            snp_flag_a | np.uint8(0x80)]),
            np.concatenate([np.zeros_like(ref_flag_a), snp_info_a]),
            target_load=ht_target_load)
        cache.save(**{ht_name: both_tab.table},
                   meta={f"both_nb_{tag}": both_tab.nb,
                         f"both_chain_{tag}": both_tab.chain})

    def jumpgate24(keys_hi_sorted, shift: int):
        """Prefix counts over the top 24 key bits of a SORTED u32 key
        array: jg[h] = first row whose (key >> shift) >= h, via
        searchsorted with the boundary values -- no full-width bincount
        temporaries (they cost 8 B/key at whole-genome scale).
        Returns (jg, max_block_rows)."""
        bounds = np.arange((1 << 24) + 1, dtype=np.uint64) << np.uint64(
            shift)
        bounds = np.minimum(bounds, np.uint64(0xFFFFFFFF)).astype(
            np.uint32)
        jg64 = np.searchsorted(keys_hi_sorted, bounds, side="left")
        jg64[-1] = keys_hi_sorted.shape[0]
        maxblk = int(np.diff(jg64).max(initial=1))
        return jg64.astype(np.uint32), maxblk

    n_ref_rows = int(ref_hi.shape[0])
    n_snp_rows = int(snp_hi.shape[0])

    if cache.has("ref_jg", "snp_jg", "ref_win_rows", "ref_scan_max",
                 "snp_scan_max"):
        ref_jg = cache.load("ref_jg")
        snp_jg = cache.load("snp_jg")
        ref_win_rows = cache.meta["ref_win_rows"]
        ref_scan_max = cache.meta["ref_scan_max"]
        snp_scan_max = cache.meta["snp_scan_max"]
    else:
        ref_jg, ref_maxblk = jumpgate24(ref_hi, 8)
        snp_jg, snp_maxblk24 = jumpgate24(snp_hi, 8)
        ref_win_rows = max(1, (max(ref_maxblk, 1) + 62) // 32)
        ref_scan_max = max_run(ref_hi)            # hi32 blocks
        snp_scan_max = max(1, int(snp_maxblk24))  # snp blocks = hi24 blocks
        cache.save(meta=dict(ref_win_rows=ref_win_rows,
                             ref_scan_max=ref_scan_max,
                             snp_scan_max=snp_scan_max),
                   ref_jg=ref_jg, snp_jg=snp_jg)

    def pad32(a):
        """Zero-pad rows to a multiple of 32.  Reads in the pad region
        return 0, which is exactly the engine's out-of-dict semantics (the
        stride-bug 'fresh mmap reads as 0' model, backend.ref_scan), so the
        padding is behaviorally invisible; it exists so ref_hi can be
        reshaped (n/32, 32) for free inside jit (window gathers)."""
        n = a.shape[0]
        p = -n % 32
        if p == 0:
            return a
        return np.concatenate([a, np.zeros((p,) + a.shape[1:], a.dtype)])

    from .hashtable import prefilter_bits

    def pf_size(n):
        # ~32 bits per key, power of two, min 1 Mbit; the bucket hash is
        # 32-bit so 2^32 bits is the addressable maximum (512 MB; beyond
        # ~1G keys the fill rises and pruning degrades -- such indexes
        # belong in sharded-dictionary mode anyway)
        b = 1 << max(20, int(np.ceil(np.log2(max(n, 1) * 32))))
        return min(b, 1 << 32)

    if skip_tables:
        both_pf_bits = 1024
        both_pf = np.zeros(1024 // 32, np.uint32)
    else:
        both_pf_bits = pf_size(ref_hi.shape[0] + snp_hi.shape[0])
        if cache.has("both_pf"):
            both_pf = cache.load("both_pf")
        else:
            both_pf = prefilter_bits(
                np.concatenate([ref_hi, snp_hi]),
                np.concatenate([ref_lo, snp_lo]), both_pf_bits)
            cache.save(both_pf=both_pf)

    ref_hi, ref_lo = pad32(ref_hi), pad32(ref_lo)
    ref_pos_a, ref_flag_a = pad32(ref_pos_a), pad32(ref_flag_a)
    snp_hi, snp_lo = pad32(snp_hi), pad32(snp_lo)
    snp_pos_a, snp_info_a, snp_flag_a = (pad32(snp_pos_a),
                                         pad32(snp_info_a),
                                         pad32(snp_flag_a))
    ref_meta = np.stack([ref_pos_a.astype(np.uint32),
                         ref_flag_a.astype(np.uint32)], axis=1)
    snp_meta = np.stack(
        [snp_pos_a.astype(np.uint32),
         snp_flag_a.astype(np.uint32)
         | (snp_info_a.astype(np.uint32) << np.uint32(8))], axis=1)
    snp_test = np.stack([snp_lo, snp_hi & np.uint32(0xFF)], axis=1)

    dev = (lambda a: a) if host_only else jax.device_put
    return DeviceIndex(
        both_ht=dev(both_tab.table),
        both_ht_nb=both_tab.nb, both_ht_chain=both_tab.chain,
        both_pf=dev(both_pf), both_pf_bits=both_pf_bits,
        ref_jg=dev(ref_jg), snp_jg=dev(snp_jg),
        ref_win_rows=ref_win_rows,
        ref_scan_max=ref_scan_max, snp_scan_max=snp_scan_max,
        n_ref_rows=n_ref_rows, n_snp_rows=n_snp_rows,
        ref_hi=dev(ref_hi if host_only else ref_hi.reshape(-1, 32)),
        ref_lo=dev(ref_lo),
        ref_meta=dev(ref_meta),
        aux_all=dev(np.concatenate([
            np.stack([ref_aux_a.astype(np.uint32),
                      np.zeros_like(ref_aux_a, np.uint32)], axis=-1),
            np.stack([snp_aux_pos_a.astype(np.uint32),
                      snp_aux_snp_a.astype(np.uint32)], axis=-1)])),
        n_ref_aux=int(ref_aux_a.shape[0]),
        snp_hi=dev(snp_hi), snp_lo=dev(snp_lo),
        snp_meta=dev(snp_meta), snp_test=dev(snp_test),
        ref_bf=dev(index.ref_bf.as_u32()),
        snp_bf=dev(index.snp_bf.as_u32()),
        site_pos=dev(site_pos_a), site_ref=dev(site_ref_a),
        site_alt=dev(site_alt_a),
        site_bitmap=dev(bitmap),
        site_rank=dev(site_rank),
        site_dir=dev(site_dir),
        site_ra=dev(site_ra),
        snp_bf_bits=index.snp_bf.bits,
        ref_bf_bits=index.ref_bf.bits,
    )
