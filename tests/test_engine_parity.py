"""Batched engine end-to-end parity: engine VCF == reference binary VCF.

This is the headline correctness test: the full fixture FASTQ through the
fixed-shape device pipeline (on the CPU test mesh), then byte-comparison of the
rewritten VCF against the compiled reference's output. Overflow counters must
all be zero (no capacity truncation) for the comparison to be meaningful.
"""

import os

import pytest

from vargeno_tpu.config import GenoConfig
from vargeno_tpu.engine.geno import GenoRunner



FIX = os.path.join(os.path.dirname(__file__), "fixtures", "mini")


def test_engine_end_to_end_parity(mini_index, tmp_path):  # noqa: F811
    cfg = GenoConfig(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
    runner = GenoRunner(mini_index, cfg)
    runner.consume_fastq(os.path.join(FIX, "reads.fq"))
    assert all(v == 0 for k, v in runner.stats_totals.items()
               if "overflow" in k), runner.stats_totals
    out = str(tmp_path / "engine_output.vcf")
    runner.write_vcf(os.path.join(FIX, "snps.vcf"), out)
    golden = open(os.path.join(FIX, "golden_output.vcf")).read()
    assert open(out).read() == golden
