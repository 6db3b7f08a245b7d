"""Long-read handling at DEFAULT flags.

The reference handles reads up to its 1023-char fgets buffer
(src/qv.cc:700), flooring each to a 32-base multiple (qv.cc:778-779).
``reads_long.fq`` mixes 101/300/320/640/992-base reads over the mini
genome; ``golden_long_output.vcf`` is the compiled reference binary's
output (tools/make_longread_fixture.py). The CLI must reproduce it with
NO explicit --max-read-len (auto-sizing from the FASTQ peek)."""

import os

import numpy as np
import pytest

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "mini")
LONG_FQ = os.path.join(FIX, "reads_long.fq")
GOLDEN = os.path.join(FIX, "golden_long_output.vcf")


def test_autosize_read_len():
    from vargeno_tpu.io.fastq import autosize_read_len, peek_max_read_len

    assert peek_max_read_len(LONG_FQ) == 992
    assert autosize_read_len(LONG_FQ) == 992
    # short-read file keeps the standard 128 envelope
    assert autosize_read_len(os.path.join(FIX, "reads.fq")) == 128


def test_long_reads_default_flags_match_reference(mini_index, tmp_path):
    """End-to-end GenoRunner with the CLI's auto-sized config (no explicit
    length flags) must byte-match the reference binary's output."""
    from vargeno_tpu.config import GenoConfig
    from vargeno_tpu.engine.geno import GenoRunner
    from vargeno_tpu.io.fastq import autosize_read_len

    L = autosize_read_len(LONG_FQ)   # what the CLI would pick
    cfg = GenoConfig(batch_reads=512, max_read_len=L,
                     max_kmers_per_read=L // 32)
    runner = GenoRunner(mini_index, cfg)
    runner.consume_fastq(LONG_FQ)
    out = str(tmp_path / "long_output.vcf")
    runner.write_vcf(os.path.join(FIX, "snps.vcf"), out)
    assert open(out).read() == open(GOLDEN).read()


def test_truncation_warns(mini_index):
    """A config too small for the file's reads must WARN (never silent)."""
    from vargeno_tpu.io.fastq import iter_read_batches

    with pytest.warns(UserWarning, match="TRUNCATED"):
        n = 0
        for b in iter_read_batches(LONG_FQ, 512, 128, 4):
            n += b.n_valid
        assert n > 0

    # the numpy fallback path warns too
    with pytest.warns(UserWarning, match="TRUNCATED"):
        for b in iter_read_batches(LONG_FQ, 512, 128, 4,
                                   use_native=False):
            pass


def test_long_reads_on_mesh(mini_index, tmp_path):
    """Same long-read workload through the data-parallel mesh runner."""
    from vargeno_tpu.config import GenoConfig
    from vargeno_tpu.dist.sharding import ShardedGenoRunner, make_mesh
    from vargeno_tpu.io.fastq import autosize_read_len

    L = autosize_read_len(LONG_FQ)
    cfg = GenoConfig(batch_reads=64, max_read_len=L,
                     max_kmers_per_read=L // 32)
    runner = ShardedGenoRunner(mini_index, make_mesh(8), cfg)
    runner.consume_fastq(LONG_FQ)
    out = str(tmp_path / "long_mesh.vcf")
    runner.write_vcf(os.path.join(FIX, "snps.vcf"), out)
    assert open(out).read() == open(GOLDEN).read()
