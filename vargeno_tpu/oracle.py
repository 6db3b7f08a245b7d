"""Sequential oracle engine: a faithful host-side model of `vargeno geno`.

This is NOT the device engine (see vargeno_tpu.engine). It is a deliberately
direct numpy/Python restatement of the reference's genotyping loop
(src/qv.cc:475-1848), used as (a) the behavioral specification the batched
device engine is tested against read-by-read, and (b) a debuggable slow path.

Replicated reference behaviors (with citations):
- jumpgate-block exact queries == full-key binary search (qv.cc:194-240).
- voting via improved_index_table_add: neighbor votes only attach to
  positions already seen, a position needs >=2 distinct supporting k-mer
  positions, live-frequency best/ambiguous state machine (qv.cc:132-178).
- neighbor search gated on qual[k-mer index] < '8' (qv.cc:836,943).
- Bloom-filter pruning of hi-half probes (qv.cc:946-956).
- big-block 96-probe enumeration vs small-block Hamming scan of the
  jumpgate block (qv.cc:962-1209), INCLUDING the small-block scan's
  pointer-arithmetic stride bug: the Hamming test reads the k-mer bits of
  entry ``lo + sizeof(entry)*(i-lo)`` (stride 9 entries for ref, 11 for
  snp; qv.cc:359, 448) while hit metadata comes from entry ``i``.
  Out-of-bounds test reads are modeled as zeros (fresh-mmap heap).
- suppression of ref neighbor hits at known SNP sites and of snp neighbor
  hits mutating the SNP position itself (qv.cc:985-993, 1055).
- reverse-complement retry only after a failed forward pass, quality string
  not reversed (qv.cc:786-806, 1504-1510).
- pileup with saturating 6-bit counters (qv.cc:1382-1502).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import (FLAG_AMBIGUOUS, FLAG_UNAMBIGUOUS, GenoConfig,
                     NO_MODIFICATION, POS_AMBIGUOUS)
from .core.hashes import np_hash32, np_hash40
from .index.store import VarGenoIndex

U32 = 0xFFFFFFFF
LO40_MASK = 0xFF_FFFF_FFFF


def _hamming1_diff(x: int) -> Optional[int]:
    """If XOR pattern x is confined to one 2-bit base field, return the base
    index, else None (one_hamming_distance_{32,64}, qv.cc:267-312)."""
    if x == 0:
        return None
    k = ((x & -x).bit_length() - 1) // 2
    if x & ~(0x3 << (2 * k)):
        return None
    return k


class OracleEngine:
    def __init__(self, index: VarGenoIndex, config: GenoConfig | None = None):
        self.config = config or GenoConfig()
        self.idx = index
        self.ref_kmers = index.ref.kmers
        self.ref_pos = index.ref.pos
        self.ref_flag = index.ref.flag
        self.ref_aux = index.ref.aux
        self.snp_kmers = index.snp.kmers
        self.snp_pos = index.snp.pos
        self.snp_info = index.snp.snp
        self.snp_flag = index.snp.flag
        self.snp_aux_pos = index.snp.aux_pos
        self.snp_aux_snp = index.snp.aux_snp
        # pileup: site position -> [ref, alt, rf, af, ref_cnt, alt_cnt]
        self.pileup: Dict[int, list] = {}
        s = index.sites
        for p, r, a, rf, af in zip(s.pos, s.ref, s.alt, s.rf, s.af):
            self.pileup[int(p)] = [int(r), int(a), int(rf), int(af), 0, 0]
        self.ref_bf = index.ref_bf
        self.snp_bf = index.snp_bf
        # precompute hi-block boundaries lazily via searchsorted

    # --- dictionary queries ---

    def _exact(self, kmers: np.ndarray, dic: np.ndarray) -> np.ndarray:
        i = np.searchsorted(dic, kmers)
        i = np.minimum(i, len(dic) - 1) if len(dic) else np.zeros_like(i)
        hit = (len(dic) > 0) & (dic[i] == kmers) if len(dic) else i != i
        return np.where(hit, i, -1)

    def exact_ref(self, kmer: int) -> int:
        return int(self._exact(np.asarray([kmer], np.uint64),
                               self.ref_kmers)[0])

    def exact_snp(self, kmer: int) -> int:
        return int(self._exact(np.asarray([kmer], np.uint64),
                               self.snp_kmers)[0])

    def ref_block(self, kmer: int) -> Tuple[int, int]:
        hi = kmer >> 32
        lo = int(np.searchsorted(self.ref_kmers, np.uint64(hi << 32)))
        hi_b = int(np.searchsorted(self.ref_kmers,
                                   np.uint64(((hi + 1) << 32) - 1), "right"))
        return lo, hi_b

    def snp_block(self, kmer: int) -> Tuple[int, int]:
        hi24 = kmer >> 40
        lo = int(np.searchsorted(self.snp_kmers, np.uint64(hi24 << 40)))
        hi_b = int(np.searchsorted(self.snp_kmers,
                                   np.uint64(((hi24 + 1) << 40) - 1), "right"))
        return lo, hi_b

    # --- Bloom probes ---

    def ref_bf_hit(self, kmer: int) -> bool:
        bit = int(np_hash32(np.uint32(kmer & U32))) % self.ref_bf.bits
        return bool(self.ref_bf.test_bits(np.asarray([bit], np.uint64))[0])

    def snp_bf_hit(self, kmer: int) -> bool:
        h = int(np_hash40(np.uint64(kmer & LO40_MASK)) %
                np.uint64(self.snp_bf.bits))
        return bool(self.snp_bf.test_bits(np.asarray([h], np.uint64))[0])

    # --- site checks ---

    def is_site(self, pos: int) -> bool:
        """pileup_table[pos].ref != 0 or .alt != 0 (the neighbor-suppression
        check, qv.cc:990-992). A seeded site always has ref != alt so this is
        exactly site membership... except a site with ref==A(0) and alt==A
        cannot exist (alt != ref guaranteed by dictgen)."""
        e = self.pileup.get(pos)
        if e is None:
            return False
        return not (e[0] == 0 and e[1] == 0)

    # --- the per-read engine ---

    def process_read(self, seq: str, qual: str) -> Optional[dict]:
        """Run one read through both orientations; updates the pileup.
        Returns debug info for tests."""
        cfg = self.config
        read_len_true = len(seq)
        length = (read_len_true // 32) * 32
        debug = {"orientations": []}

        revcompl = False
        while True:
            if revcompl:
                comp = {"A": "T", "a": "T", "C": "G", "c": "G",
                        "G": "C", "g": "C", "T": "A", "t": "A"}
                try:
                    seq_active = "".join(
                        comp[c] for c in reversed(seq[:length]))
                except KeyError:
                    return debug  # non-ACGT in reverse pass: read dropped
            else:
                seq_active = seq

            kmers = []
            had_n = False
            for i in range(0, length, 32):
                k = 0
                for j in range(32):
                    c = seq_active[i + j]
                    if c in "Nn":
                        had_n = True
                        break
                    code = {"A": 0, "a": 0, "C": 1, "c": 1,
                            "G": 2, "g": 2, "T": 3, "t": 3}.get(c)
                    if code is None:
                        raise ValueError(f"invalid base {c!r}")
                    k |= code << (2 * j)
                if had_n:
                    break
                kmers.append(k)
            if had_n:
                return debug  # read skipped; no revcompl retry (qv.cc:824)

            result = self._process_oriented(kmers, qual)
            debug["orientations"].append(result)
            if result["process"]:
                self._accumulate(result)
                return debug
            if not revcompl:
                revcompl = True
                continue
            return debug

    def _process_oriented(self, kmers: List[int], qual: str) -> dict:
        cfg = self.config
        freq: Dict[int, int] = {}
        support: Dict[int, set] = {}
        state = {"best": None, "ambiguous": False}
        ref_ctx: List[tuple] = []  # (kmer, read_pos, kmer_pos, modified_pos)
        snp_ctx: List[tuple] = []

        def add(index: int, kmer_pos: int, is_neighbor: bool = True):
            if is_neighbor and index not in support:
                return
            freq[index] = freq.get(index, 0) + 1
            support.setdefault(index, set()).add(kmer_pos)
            if len(support[index]) <= 1:
                return
            best = state["best"]
            if best is None:
                state["best"] = index
                state["ambiguous"] = False
            elif index == best:
                state["ambiguous"] = False
            elif freq[index] == freq[best]:
                state["ambiguous"] = True
            elif freq[index] > freq[best]:
                state["best"] = index
                state["ambiguous"] = False

        def handle_ref_exact(row: int, kmer: int, offset: int):
            pos = int(self.ref_pos[row])
            if pos == POS_AMBIGUOUS:
                return
            if self.ref_flag[row] == FLAG_UNAMBIGUOUS:
                read_pos = (pos - offset) & U32
                ref_ctx.append((kmer, read_pos, pos, NO_MODIFICATION))
                add(read_pos, pos, False)
            else:
                for p in self.ref_aux[pos]:
                    p = int(p)
                    if p == 0:
                        break
                    read_pos = (p - offset) & U32
                    ref_ctx.append((kmer, read_pos, p, NO_MODIFICATION))
                    add(read_pos, p, False)

        def handle_snp_exact(row: int, kmer: int, offset: int):
            pos = int(self.snp_pos[row])
            if pos == POS_AMBIGUOUS:
                return
            if self.snp_flag[row] == FLAG_UNAMBIGUOUS:
                read_pos = (pos - offset) & U32
                snp_ctx.append((kmer, read_pos, pos, NO_MODIFICATION))
                add(read_pos, pos, False)
            else:
                for p in self.snp_aux_pos[pos]:
                    p = int(p)
                    if p == 0:
                        break
                    read_pos = (p - offset) & U32
                    snp_ctx.append((kmer, read_pos, p, NO_MODIFICATION))
                    add(read_pos, p, False)

        def handle_ref_neighbor(row: int, neighbor: int, offset: int,
                                diff: int):
            pos = int(self.ref_pos[row])
            if pos == POS_AMBIGUOUS:
                return
            if self.ref_flag[row] == FLAG_UNAMBIGUOUS:
                if not self.is_site(pos + diff):
                    read_pos = (pos - offset) & U32
                    ref_ctx.append((neighbor, read_pos, pos, diff))
                    add(read_pos, pos, True)
            else:
                for p in self.ref_aux[pos]:
                    p = int(p)
                    if p == 0:
                        break
                    if not self.is_site(p + diff):
                        read_pos = (p - offset) & U32
                        ref_ctx.append((neighbor, read_pos, p, diff))
                        add(read_pos, p, True)

        def handle_snp_neighbor(row: int, neighbor: int, offset: int,
                                diff: int):
            pos = int(self.snp_pos[row])
            if pos == POS_AMBIGUOUS:
                return
            if self.snp_flag[row] == FLAG_UNAMBIGUOUS:
                if ((self.snp_info[row] >> 3) & 0x1F) != diff:
                    read_pos = (pos - offset) & U32
                    snp_ctx.append((neighbor, read_pos, pos, diff))
                    add(read_pos, pos, True)
            else:
                for p, s in zip(self.snp_aux_pos[pos], self.snp_aux_snp[pos]):
                    p = int(p)
                    if p == 0:
                        break
                    if ((int(s) >> 3) & 0x1F) != diff:
                        read_pos = (p - offset) & U32
                        snp_ctx.append((neighbor, read_pos, p, diff))
                        add(read_pos, p, True)

        for i, kmer in enumerate(kmers):
            qual_char = qual[i] if i < len(qual) else "\0"
            offset = 32 * i

            r = self.exact_ref(kmer)
            s = self.exact_snp(kmer)
            blo, bhi = self.ref_block(kmer)
            block_size = bhi - blo

            if r >= 0:
                handle_ref_exact(r, kmer, offset)
            if s >= 0:
                handle_snp_exact(s, kmer, offset)

            if ord(qual_char) >= cfg.quality_score:
                continue

            ref_bound = 64 if self.ref_bf_hit(kmer) else 32
            snp_bound = 64 if self.snp_bf_hit(kmer) else 40
            big = block_size >= cfg.block_size_threshold

            if big:
                # enumerate lo-half neighbors: bases 0..15 (qv.cc:965-1108)
                for bitpos in range(0, 32, 2):
                    diff = bitpos // 2
                    base = (kmer >> bitpos) & 3
                    for j in range(4):
                        if j == base:
                            continue
                        nb = (kmer & ~(3 << bitpos)) | (j << bitpos)
                        rr = self.exact_ref(nb)
                        ss = self.exact_snp(nb)
                        if rr >= 0:
                            handle_ref_neighbor(rr, nb, offset, diff)
                        if ss >= 0:
                            handle_snp_neighbor(ss, nb, offset, diff)
            else:
                # small-block Hamming scans (qv.cc:1110-1209), with the
                # stride bug (test entry at lo + sizeof*(i-lo)).
                stride_r = 9 if self.config_stride_bug else 1
                n_ref = len(self.ref_kmers)
                for irow in range(blo, bhi):
                    test_idx = blo + stride_r * (irow - blo)
                    if test_idx < n_ref:
                        entry_lo = int(self.ref_kmers[test_idx]) & U32
                    else:
                        entry_lo = 0
                    diff = _hamming1_diff((kmer & U32) ^ entry_lo)
                    if diff is None:
                        continue
                    nb = (kmer >> 32 << 32) | entry_lo
                    handle_ref_neighbor(irow, nb, offset, diff)
                slo, shi = self.snp_block(kmer)
                stride_s = 11 if self.config_stride_bug else 1
                n_snp = len(self.snp_kmers)
                for irow in range(slo, shi):
                    test_idx = slo + stride_s * (irow - slo)
                    if test_idx < n_snp:
                        entry_lo40 = int(self.snp_kmers[test_idx]) & LO40_MASK
                    else:
                        entry_lo40 = 0
                    diff = _hamming1_diff((kmer & LO40_MASK) ^ entry_lo40)
                    if diff is None:
                        continue
                    nb = (kmer >> 40 << 40) | entry_lo40
                    handle_snp_neighbor(irow, nb, offset, diff)

            # hi-half probes: bases 16..31 (qv.cc:1213-1365)
            for bitpos in range(32, 64, 2):
                diff = bitpos // 2
                base = (kmer >> bitpos) & 3
                for j in range(4):
                    if j == base:
                        continue
                    nb = (kmer & ~(3 << bitpos)) | (j << bitpos)
                    if bitpos < ref_bound:
                        rr = self.exact_ref(nb)
                        if rr >= 0:
                            handle_ref_neighbor(rr, nb, offset, diff)
                    if big or bitpos >= 40:
                        if bitpos >= snp_bound:
                            continue
                        ss = self.exact_snp(nb)
                        if ss >= 0:
                            handle_snp_neighbor(ss, nb, offset, diff)

        best = state["best"]
        process = (best is not None and freq[best] > 1
                   and not state["ambiguous"])
        return {
            "process": process,
            "target": best if best is not None else 0,
            "ref_ctx": ref_ctx,
            "snp_ctx": snp_ctx,
            "best": best,
            "best_freq": freq.get(best, 0) if best is not None else 0,
            "ambiguous": state["ambiguous"],
        }

    config_stride_bug = True

    def _accumulate(self, result: dict) -> None:
        """Pileup update over agreeing contexts (qv.cc:1382-1502)."""
        target = result["target"]
        max_cov = self.config.max_cov
        for ctx_list in (result["ref_ctx"], result["snp_ctx"]):
            for kmer, read_pos, kmer_pos, modified in ctx_list:
                if read_pos != target:
                    continue
                for i in range(32):
                    if i == modified:
                        continue
                    e = self.pileup.get(kmer_pos + i)
                    if e is None or e[0] == e[1]:
                        continue
                    base = (kmer >> (2 * i)) & 3
                    if base == e[0]:
                        if e[4] != max_cov:
                            e[4] += 1
                    elif base == e[1]:
                        if e[5] != max_cov:
                            e[5] += 1

    # --- end-to-end ---

    def run_fastq(self, path: str, limit: int | None = None) -> None:
        n = 0
        with open(path) as f:
            while True:
                rid = f.readline()
                if not rid:
                    break
                seq = f.readline().rstrip("\n")
                f.readline()
                q = f.readline().rstrip("\n")
                self.process_read(seq, q)
                n += 1
                if limit and n >= limit:
                    break

    def run_fastq_parallel(self, path: str, workers: int | None = None,
                           limit: int | None = None) -> None:
        """Fork-parallel run_fastq: read records are split round-robin
        across worker processes (index arrays shared copy-on-write), each
        runs the UNCHANGED per-read spec loop, and per-site counts merge
        with saturating adds -- exact, because the 6-bit saturation is a
        monotone clamp of an additive counter (min(63, c1+c2) == clamp of
        the true total whenever each part is itself clamped). Enables
        fuzzing the engine against the spec at 10^5-10^6 reads
        (tools/fuzz_diff.py)."""
        import multiprocessing as mp

        workers = workers or min(mp.cpu_count(), 8)
        if workers <= 1:
            return self.run_fastq(path, limit=limit)
        with open(path) as f:
            lines = f.read().splitlines()
        recs = [(lines[i + 1], lines[i + 3])
                for i in range(0, len(lines) - 3, 4)]
        if limit:
            recs = recs[:limit]
        chunks = [recs[w::workers] for w in range(workers)]

        global _ORACLE_FORK_STATE
        _ORACLE_FORK_STATE = (self.idx, self.config)
        ctx = mp.get_context("fork")
        with ctx.Pool(workers) as pool:
            results = pool.map(_oracle_worker, chunks)
        max_cov = self.config.max_cov
        for part in results:
            for pos, (rc, ac) in part.items():
                e = self.pileup.get(pos)
                if e is None:
                    continue
                e[4] = min(max_cov, e[4] + rc)
                e[5] = min(max_cov, e[5] + ac)

    def counts(self):
        """Sorted (pos, ref, alt, rf, af, ref_cnt, alt_cnt) arrays."""
        items = sorted(self.pileup.items())
        pos = np.array([p for p, _ in items], np.uint32)
        vals = np.array([v for _, v in items], np.int64)
        return pos, vals


_ORACLE_FORK_STATE = None


def _oracle_worker(recs):
    """Forked worker: fresh engine over the shared index; returns only the
    nonzero per-site (ref_cnt, alt_cnt) deltas."""
    idx, cfg = _ORACLE_FORK_STATE
    eng = OracleEngine(idx, cfg)
    for seq, q in recs:
        eng.process_read(seq, q)
    return {pos: (e[4], e[5]) for pos, e in eng.pileup.items()
            if e[4] or e[5]}
