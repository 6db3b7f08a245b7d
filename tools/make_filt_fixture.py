#!/usr/bin/env python3
"""`filt` golden fixture.

Runs the reference binary's `filt` subcommand (src/dict_filt.c:23-79,
CLI src/qv.cc:2009-2025) on the mini fixture's golden ref.dict, using a
snp-locations file in the reference's GEN_FLT_DATA format (u64 size +
u8 per genome position -- src/qv.cc:1990-1994 writes it; the shipped
binary compiles it out, so we serialize our builder's identical
snp_locations array). Also produces the geno-after-filt golden VCF by
running the reference geno against the filtered dictionary.

Outputs (tests/fixtures/mini/): golden.filt.ref.dict, snp_locs.bin,
golden_filt_output.vcf.
"""

import os
import shutil
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "fixtures", "mini")
REF_BIN = sys.argv[1] if len(sys.argv) > 1 else "/tmp/refbuild/vargeno"


def main():
    from vargeno_tpu.index import dictgen
    from vargeno_tpu.io import fasta as fasta_io

    seqs = fasta_io.parse_fasta(os.path.join(OUT, "genome.fa"))
    _, locs = dictgen.build_snp_dict_from_vcf(
        seqs, os.path.join(OUT, "snps.vcf"))
    locs_path = os.path.join(OUT, "snp_locs.bin")
    with open(locs_path, "wb") as f:
        f.write(np.uint64(locs.shape[0]).tobytes())
        f.write(locs.astype(np.uint8).tobytes())
    print(f"snp_locations: {locs.shape[0]} positions, {locs.sum()} set")

    golden_dict = os.path.join(OUT, "golden.ref.dict")
    filt_out = os.path.join(OUT, "golden.filt.ref.dict")
    subprocess.run([REF_BIN, "filt", golden_dict, locs_path, filt_out],
                   check=True)
    print(f"filtered dict -> {filt_out}")

    # geno against the filtered dict: reference index files + filtered
    # ref.dict under a scratch prefix
    scratch = "/tmp/fixture_golden_filt"
    os.makedirs(scratch, exist_ok=True)
    prefix = os.path.join(scratch, "mini")
    src_prefix = "/tmp/fixture_golden_long/mini"   # built by longread tool
    if not os.path.exists(src_prefix + ".snp.dict"):
        subprocess.run([REF_BIN, "index",
                        os.path.join(OUT, "genome.fa"),
                        os.path.join(OUT, "snps.vcf"), src_prefix],
                       check=True)
    for ext in (".snp.dict", ".ref.bf", ".snp.bf", ".chrlens"):
        shutil.copy(src_prefix + ext, prefix + ext)
    shutil.copy(filt_out, prefix + ".ref.dict")
    golden_vcf = os.path.join(OUT, "golden_filt_output.vcf")
    subprocess.run([REF_BIN, "geno", prefix,
                    os.path.join(OUT, "reads.fq"),
                    os.path.join(OUT, "snps.vcf"), golden_vcf], check=True)
    print(f"geno-after-filt golden -> {golden_vcf}")


if __name__ == "__main__":
    main()
