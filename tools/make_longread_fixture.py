#!/usr/bin/env python3
"""Long-read fixture: mixed-length reads (101..992 bases) over the mini
genome + golden output from the reference binary.

The reference handles reads up to its 1023-char fgets buffer
(/root/reference/src/qv.cc:700) and floors each to a 32-multiple
(qv.cc:778-779). This fixture pins the repo's default-flag behavior on
>128 bp inputs.

Usage: python tools/make_longread_fixture.py [--ref-binary /tmp/refbuild/vargeno]
"""

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools.make_fixture import (COMP, make_genome, pick_snp_sites,  # noqa: E402
                                write_fastq)

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "fixtures", "mini")


def simulate_long_reads(rng, seqs, rows, lengths, n_per_len=600):
    genomes = {name: np.char.upper(arr).copy() for name, arr in seqs}
    gts = {}
    for r in rows:
        if len(r["ref"]) != 1 or len(r["alt"]) != 1 or r["ref"] == r["alt"]:
            continue
        gts[(r["chrom"], r["pos"])] = int(rng.choice([0, 1, 2],
                                                     p=[0.55, 0.25, 0.20]))
    names = [n for n, _ in seqs]
    lens = {n: len(a) for n, a in seqs}
    reads = []
    i = 0
    for read_len in lengths:
        K = read_len // 32
        for _ in range(n_per_len):
            chrom = names[int(rng.integers(0, 2))]
            n = lens[chrom]
            start = int(rng.integers(0, n - read_len))
            hap = int(rng.integers(0, 2))
            seq = genomes[chrom][start:start + read_len].copy()
            for r in rows:
                if r["chrom"] != chrom:
                    continue
                p0 = r["pos"] - 1
                if not (start <= p0 < start + read_len):
                    continue
                gt = gts.get((r["chrom"], r["pos"]))
                if gt is None:
                    continue
                if ((gt == 2) or (gt == 1 and hap == 1)) \
                        and len(r["alt"]) == 1:
                    seq[p0 - start] = r["alt"]
            qual = np.full(read_len, "I")
            if rng.random() < 0.3:   # error + low-qual kmer-index char
                kidx = int(rng.integers(0, max(K, 1)))
                epos = int(rng.integers(kidx * 32,
                                        min((kidx + 1) * 32, read_len)))
                old = seq[epos]
                if old in "ACGT":
                    seq[epos] = rng.choice(
                        [b for b in "ACGT" if b != old])
                    qual[kidx] = "0"
            s = "".join(seq)
            if rng.random() < 0.5:
                s = "".join(COMP[c] for c in reversed(s))
            reads.append((f"@L{i}", s, "".join(qual)))
            i += 1
    return reads


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-binary", default="/tmp/refbuild/vargeno")
    args = ap.parse_args()

    # deterministic regeneration of the SAME genome + VCF rows as
    # tools/make_fixture.py (same seed/stream order)
    rng = np.random.default_rng(20260817)
    seqs = make_genome(rng)
    rows = pick_snp_sites(rng, seqs)

    rng2 = np.random.default_rng(99887766)
    # mixed lengths: default-128 case, >128 non-multiple, 32-multiples,
    # and the reference's near-envelope 992
    reads = simulate_long_reads(rng2, seqs, rows,
                                lengths=(101, 300, 320, 640, 992))
    fq = os.path.join(OUT, "reads_long.fq")
    write_fastq(fq, reads)
    print(f"{len(reads)} long reads -> {fq}")

    if not os.path.exists(args.ref_binary):
        print("reference binary missing; golden not regenerated",
              file=sys.stderr)
        return
    scratch = "/tmp/fixture_golden_long"
    os.makedirs(scratch, exist_ok=True)
    prefix = os.path.join(scratch, "mini")
    if not os.path.exists(prefix + ".ref.dict"):
        subprocess.run([args.ref_binary, "index",
                        os.path.join(OUT, "genome.fa"),
                        os.path.join(OUT, "snps.vcf"), prefix], check=True)
    golden = os.path.join(OUT, "golden_long_output.vcf")
    subprocess.run([args.ref_binary, "geno", prefix, fq,
                    os.path.join(OUT, "snps.vcf"), golden], check=True)
    print(f"golden -> {golden}")


if __name__ == "__main__":
    main()
