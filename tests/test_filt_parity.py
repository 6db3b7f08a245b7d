"""`filt` golden parity vs the reference binary.

``golden.filt.ref.dict`` is the output of the compiled reference's
``vargeno filt`` (src/dict_filt.c:23-79) on the mini fixture's golden
ref.dict + its GEN_FLT_DATA snp-locations file; ``golden_filt_output.vcf``
is the reference's geno run against that filtered dictionary
(tools/make_filt_fixture.py)."""

import os

import numpy as np
import pytest

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "mini")
GOLDEN_FILT = os.path.join(FIX, "golden.filt.ref.dict")


@pytest.fixture(scope="module")
def filt_index(mini_index):
    import copy

    from vargeno_tpu.index.filt import filt_ref_dict

    idx = copy.copy(mini_index)
    idx.ref = filt_ref_dict(mini_index.ref, mini_index.snp_locations)
    # don't let the filtered index write into the unfiltered index's
    # derived-table disk cache
    if hasattr(idx, "prefix"):
        idx.prefix = None
    return idx


def test_filt_dict_bit_identical(filt_index, tmp_path):
    from vargeno_tpu.index import store

    out = str(tmp_path / "filt.ref.dict")
    store.write_ref_dict(out, filt_index.ref)
    assert open(out, "rb").read() == open(GOLDEN_FILT, "rb").read()


def test_snp_locations_format_roundtrip(mini_index, tmp_path):
    """Our snp_locations array serializes to the reference's GEN_FLT_DATA
    file format (u64 size + u8 flags, src/qv.cc:1985-1994)."""
    locs = mini_index.snp_locations
    p = str(tmp_path / "locs.bin")
    with open(p, "wb") as f:
        f.write(np.uint64(locs.shape[0]).tobytes())
        f.write(locs.astype(np.uint8).tobytes())
    raw = open(p, "rb").read()
    n = int(np.frombuffer(raw[:8], np.uint64)[0])
    back = np.frombuffer(raw[8:], np.uint8).astype(bool)
    assert n == locs.shape[0]
    np.testing.assert_array_equal(back, locs)


def test_geno_after_filt_matches_reference(filt_index, tmp_path):
    """End-to-end geno against the FILTERED dictionary must byte-match the
    reference binary's geno-after-filt output."""
    from vargeno_tpu.config import GenoConfig
    from vargeno_tpu.engine.geno import GenoRunner

    cfg = GenoConfig(batch_reads=512, max_read_len=128,
                     max_kmers_per_read=4)
    runner = GenoRunner(filt_index, cfg)
    runner.consume_fastq(os.path.join(FIX, "reads.fq"))
    out = str(tmp_path / "filt_output.vcf")
    runner.write_vcf(os.path.join(FIX, "snps.vcf"), out)
    golden = open(os.path.join(FIX, "golden_filt_output.vcf")).read()
    assert open(out).read() == golden
