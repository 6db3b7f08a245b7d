"""Synthetic dataset + index generation for tests, dryruns and benchmarks."""

from __future__ import annotations

import os
import tempfile

import numpy as np

from .config import GenoConfig
from .index import bloom, dictgen, store
from .io import fasta as fasta_io

_BASES = np.array(list("ACGT"))


def synth_genome(rng, sizes=(20_000,), names=("chrS1",)):
    out = []
    for n, name in zip(sizes, names):
        out.append((name, _BASES[rng.integers(0, 4, n)]))
    return out


def _ascii(arr) -> bytes:
    """A U1 base array as ASCII bytes (one byte per base; U1 stores each
    character as one UCS-4 code unit)."""
    return np.ascontiguousarray(arr).view(np.uint32).astype(np.uint8) \
        .tobytes()


def write_inputs(tmpdir: str, rng, genome, n_snps=40, n_reads=2000,
                 read_len=101, err_frac=0.15):
    fa = os.path.join(tmpdir, "genome.fa")
    with open(fa, "wb") as f:
        for name, arr in genome:
            f.write(f">{name}\n".encode())
            s = _ascii(arr)
            f.write(b"".join(s[i:i + 70] + b"\n"
                             for i in range(0, len(s), 70)))

    rows = []
    gts = {}
    for j in range(n_snps):
        ci = int(rng.integers(0, len(genome)))
        name, arr = genome[ci]
        p = int(rng.integers(64, len(arr) - 64))
        ref = str(arr[p])
        alt = str(rng.choice([b for b in "ACGT" if b != ref]))
        caf = float(rng.choice([0.99, 0.9, 0.7]))
        rows.append((name, p + 1, f"rs{j}", ref, alt,
                     f"RS={j};CAF={caf:.4g},{1-caf:.4g}"))
        gts[(name, p)] = int(rng.choice([0, 1, 2], p=[0.5, 0.3, 0.2]))
    rows.sort(key=lambda r: (r[0], r[1]))
    vcf = os.path.join(tmpdir, "snps.vcf")
    with open(vcf, "w") as f:
        f.write("##fileformat=VCFv4.0\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for r in rows:
            f.write("\t".join(str(x) for x in r[:5]) + f"\t.\t.\t{r[5]}\n")

    # vectorized read simulation: build per-chromosome ALT haplotypes once,
    # then slice reads from REF or ALT haplotype per diploid genotype
    code_of = {"A": 0, "C": 1, "G": 2, "T": 3}
    fq = os.path.join(tmpdir, "reads.fq")
    comp_map = np.array([3, 2, 1, 0], np.uint8)
    b2c = np.frombuffer(b"ACGT", np.uint8)

    chrom_ref = {}
    chrom_alt = {}
    for name, arr in genome:
        ref_codes = np.frombuffer(_ascii(arr), np.uint8)
        lut = np.zeros(256, np.uint8)
        for b, c in code_of.items():
            lut[ord(b)] = c
        ref_codes = lut[ref_codes]
        alt_codes = ref_codes.copy()
        for r in rows:
            if r[0] != name:
                continue
            p0 = r[1] - 1
            gt = gts[(name, p0)]
            if gt >= 1:
                alt_codes[p0] = code_of[r[4]]
        chrom_ref[name] = ref_codes
        # hom-alt sites must be on BOTH haplotypes
        hom = ref_codes.copy()
        for r in rows:
            if r[0] != name:
                continue
            p0 = r[1] - 1
            if gts[(name, p0)] == 2:
                hom[p0] = code_of[r[4]]
        chrom_alt[name] = (hom, alt_codes)  # (hap0, hap1)

    names = [n for n, _ in genome]
    sizes = np.array([len(a) for _, a in genome])
    probs = sizes / sizes.sum()
    choice = rng.choice(len(genome), n_reads, p=probs)
    K = read_len // 32
    with open(fq, "wb") as f:
        for ci, name in enumerate(names):
            sel = np.flatnonzero(choice == ci)
            if sel.size == 0:
                continue
            n_c = sel.size
            L = sizes[ci]
            starts = rng.integers(0, L - read_len, n_c)
            haps = rng.integers(0, 2, n_c)
            hap0, hap1 = chrom_alt[name]
            win = starts[:, None] + np.arange(read_len)[None, :]
            reads = np.where(haps[:, None] == 0, hap0[win], hap1[win])
            # errors
            has_err = rng.random(n_c) < err_frac
            kidx = rng.integers(0, K, n_c)
            epos = kidx * 32 + rng.integers(0, 32, n_c)
            delta = rng.integers(1, 4, n_c).astype(np.uint8)
            rsel = np.flatnonzero(has_err)
            reads[rsel, epos[rsel]] = (reads[rsel, epos[rsel]]
                                       + delta[rsel]) % 4
            # reverse complement half
            is_rc = rng.random(n_c) < 0.5
            rc = comp_map[reads[:, ::-1]]
            reads = np.where(is_rc[:, None], rc, reads)
            chars = b2c[reads]
            qual_base = np.full((n_c, read_len), ord("I"), np.uint8)
            qual_base[rsel, kidx[rsel]] = ord("0")
            f.write(b"".join(
                b"@r%d_%d\n%s\n+\n%s\n" % (ci, j, chars[j].tobytes(),
                                           qual_base[j].tobytes())
                for j in range(n_c)))
    return fa, vcf, fq


def build_synth_index(fa, vcf, ref_bf_bits=1 << 20, snp_bf_bits=1 << 18,
                      lite_bits=64):
    """Small Bloom geometry for tests (full 9.6Gb filters are benchmark-only).

    Note: non-reference BF sizes change pruning decisions, so outputs are
    only comparable against an oracle using the SAME geometry -- which the
    oracle supports, since sizes live in the index."""
    seqs = fasta_io.parse_fasta(fa)
    ref_bf, _ = bloom.build_ref_bfs(seqs, ref_bf_bits, lite_bits)
    snp_bf = bloom.build_snp_bf(seqs, vcf, snp_bf_bits)
    snp_dict, locs = dictgen.build_snp_dict_from_vcf(seqs, vcf)
    ref_dict, _ = dictgen.build_ref_dict(seqs)
    return store.VarGenoIndex(
        ref=ref_dict, snp=snp_dict, ref_bf=ref_bf, snp_bf=snp_bf,
        chrlens=[(s.name, s.size) for s in seqs],
        sites=store.derive_sites(snp_dict), snp_locations=locs)


def make_synthetic(seed=0, tmpdir=None, **kw):
    rng = np.random.default_rng(seed)
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="vgt_synth_")
    genome = synth_genome(rng, kw.pop("sizes", (20_000,)),
                          kw.pop("names", ("chrS1",)))
    fa, vcf, fq = write_inputs(tmpdir, rng, genome, **kw)
    index = build_synth_index(fa, vcf)
    return index, fa, vcf, fq


def vote_reference(idx, k, isnb, valid, C: int):
    """Sequential per-read oracle of improved_index_table_add
    (qv.cc:132-178) over (E, B) event arrays, for checking the engine's
    vote (engine.batch.vote_scan). A read holds at most C candidates; an
    event that would insert into a full table is dropped and counted.
    Returns (process (B,) bool, target (B,) u32, overflow int)."""
    idx, k, isnb, valid = (np.asarray(a) for a in (idx, k, isnb, valid))
    E, B = idx.shape
    process = np.zeros(B, bool)
    target = np.zeros(B, np.uint32)
    overflow = 0
    for b in range(B):
        freq, sup = {}, {}
        best, bf, amb = None, 0, False
        for e in np.flatnonzero(valid[:, b]):
            x, kk, nb = int(idx[e, b]), int(k[e, b]), bool(isnb[e, b])
            if nb and x not in sup:
                continue
            if x not in sup and len(sup) >= C:
                overflow += 1
                continue
            freq[x] = freq.get(x, 0) + 1
            sup.setdefault(x, set()).add(kk)
            if best is not None and x == best:
                bf += 1
            if len(sup[x]) < 2:
                continue
            f2 = freq[x]
            if best is None:
                best, bf, amb = x, f2, False
            elif x == best:
                amb = False
            elif f2 == bf:
                amb = True
            elif f2 > bf:
                best, bf, amb = x, f2, False
        process[b] = best is not None and freq[best] > 1 and not amb
        target[b] = best if best is not None else 0
    return process, target, overflow
