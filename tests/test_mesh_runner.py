"""First-class mesh runner behavior: overflow escalation-and-rerun,
checkpoint/resume (including cross-layout), grouped dispatch, and the
cohort x mesh configuration -- all on the 8-device virtual CPU mesh.

The reference has no capacity limits (unbounded heap buffers,
src/qv.cc:700-758) and no mid-run checkpoint (SURVEY.md §5); these tests pin
the mesh runners to the same exactness guarantees the single-device runner
already has (tests/test_auto_retry.py)."""

import gc
import os

import numpy as np
import pytest

from vargeno_tpu.config import GenoConfig
from vargeno_tpu.dist.sharded_dict import ShardedDictGenoRunner
from vargeno_tpu.dist.sharding import ShardedGenoRunner, make_mesh

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "mini")
READS = os.path.join(FIX, "reads.fq")
GOLDEN = os.path.join(FIX, "golden_output.vcf")


def test_mesh_tiny_caps_escalate_to_exact_output(mini_index, tmp_path):
    """Force capacity overflows on the data-parallel mesh path; the batch
    must be re-run with escalated caps and still match golden byte-for-byte
    (the mesh runner once accumulated overflows silently)."""
    cfg = GenoConfig(batch_reads=64, max_read_len=128, max_kmers_per_read=4,
                     events_per_read=6, candidates_per_read=4,
                     probe_hit_cap=4, agree_cap=2, scan_slot_cap=4,
                     neighbor_item_frac=0.004, auto_retry_max=6)
    mesh = make_mesh(8)
    runner = ShardedGenoRunner(mini_index, mesh, cfg)
    runner.consume_fastq(READS)
    assert runner._cfg_run != cfg          # escalation happened
    assert all(v == 0 for k, v in runner.stats_totals.items()
               if "overflow" in k), runner.stats_totals
    out = str(tmp_path / "mesh_retry.vcf")
    runner.write_vcf(os.path.join(FIX, "snps.vcf"), out)
    assert open(out).read() == open(GOLDEN).read()


def test_mesh_checkpoint_resume_matches_uninterrupted(mini_index, tmp_path):
    cfg = GenoConfig(batch_reads=64, max_read_len=128, max_kmers_per_read=4)
    mesh = make_mesh(8)

    full = ShardedGenoRunner(mini_index, mesh, cfg)
    full.consume_fastq(READS)
    rc_full, ac_full = full._host_counts()
    del full   # each runner replicates the 1.2 GB Bloom filter 8 times
    gc.collect()

    ck = str(tmp_path / "mesh_ck")
    part = ShardedGenoRunner(mini_index, mesh, cfg)
    part.consume_fastq(READS, limit_batches=3, checkpoint_path=ck,
                       checkpoint_every=1)
    del part
    gc.collect()
    resumed = ShardedGenoRunner(mini_index, mesh, cfg)
    resumed.consume_fastq(READS, checkpoint_path=ck)
    rc_res, ac_res = resumed._host_counts()
    np.testing.assert_array_equal(rc_res, rc_full)
    np.testing.assert_array_equal(ac_res, ac_full)


def test_mesh_checkpoint_cross_layout(mini_index, tmp_path):
    """A single-device checkpoint resumes on a mesh (and produces the same
    final counts): checkpoints store merged counts, which are layout-free."""
    from vargeno_tpu.engine.geno import GenoRunner

    cfg1 = GenoConfig(batch_reads=512, max_read_len=128,
                      max_kmers_per_read=4)
    ck = str(tmp_path / "xlayout_ck")
    single = GenoRunner(mini_index, cfg1)
    single.consume_fastq(READS, limit_batches=3, checkpoint_path=ck,
                         checkpoint_every=1)
    del single
    gc.collect()

    cfg8 = GenoConfig(batch_reads=64, max_read_len=128, max_kmers_per_read=4)
    mesh = make_mesh(8)
    resumed = ShardedGenoRunner(mini_index, mesh, cfg8)
    resumed.consume_fastq(READS, checkpoint_path=ck)
    rc_res, ac_res = resumed._host_counts()
    del resumed   # the mesh runner holds 8 replicas of the index
    gc.collect()

    full = GenoRunner(mini_index, cfg1)
    full.consume_fastq(READS)
    rc_full, ac_full = full._host_counts()
    np.testing.assert_array_equal(rc_res, rc_full)
    np.testing.assert_array_equal(ac_res, ac_full)


def test_mesh_grouped_dispatch_matches_golden(mini_index, tmp_path):
    cfg = GenoConfig(batch_reads=64, max_read_len=128, max_kmers_per_read=4,
                     group_size=4)
    mesh = make_mesh(8)
    runner = ShardedGenoRunner(mini_index, mesh, cfg)
    runner.consume_fastq(READS)
    out = str(tmp_path / "mesh_grouped.vcf")
    runner.write_vcf(os.path.join(FIX, "snps.vcf"), out)
    assert open(out).read() == open(GOLDEN).read()


def test_sharded_dict_tiny_route_caps_escalate(mini_index, tmp_path):
    """Routed mode with a deliberately too-small route_factor must escalate
    (route_factor doubling via GenoConfig) and still match golden."""
    cfg = GenoConfig(batch_reads=64, max_read_len=128, max_kmers_per_read=4,
                     route_factor=0.25, auto_retry_max=8)
    mesh = make_mesh(8)
    runner = ShardedDictGenoRunner(mini_index, mesh, cfg)
    runner.consume_fastq(READS)
    assert runner._cfg_run.route_factor > cfg.route_factor
    assert all(v == 0 for k, v in runner.stats_totals.items()
               if "overflow" in k), runner.stats_totals
    out = str(tmp_path / "routed_retry.vcf")
    runner.write_vcf(os.path.join(FIX, "snps.vcf"), out)
    assert open(out).read() == open(GOLDEN).read()


def test_sharded_dict_checkpoint(mini_index, tmp_path):
    cfg = GenoConfig(batch_reads=64, max_read_len=128, max_kmers_per_read=4,
                     route_factor=8.0)
    mesh = make_mesh(8)
    ck = str(tmp_path / "routed_ck")
    part = ShardedDictGenoRunner(mini_index, mesh, cfg)
    part.consume_fastq(READS, limit_batches=2, checkpoint_path=ck,
                       checkpoint_every=1)
    resumed = ShardedDictGenoRunner(mini_index, mesh, cfg)
    resumed.consume_fastq(READS, checkpoint_path=ck)
    out = str(tmp_path / "routed_resumed.vcf")
    resumed.write_vcf(os.path.join(FIX, "snps.vcf"), out)
    assert open(out).read() == open(GOLDEN).read()


@pytest.mark.parametrize("n_samples", [3, 8])
def test_cohort_on_mesh_matches_single_runs(mini_index, tmp_path,
                                            n_samples):
    """Cohort x mesh: per-sample VCFs from the mesh cohort are byte-identical
    to independent single-device runs. n_samples=8 is the BASELINE 8-donor
    cohort configuration as written (on the fixture workload)."""
    from vargeno_tpu.engine.cohort import CohortRunner
    from vargeno_tpu.engine.geno import GenoRunner

    # split the fixture FASTQ into n_samples interleaved sub-samples
    lines = open(READS, "rb").read().splitlines(keepends=True)
    recs = [lines[i:i + 4] for i in range(0, len(lines), 4)]
    paths = []
    for s in range(n_samples):
        p = str(tmp_path / f"sample{s}.fq")
        with open(p, "wb") as f:
            for r in recs[s::n_samples]:
                f.writelines(r)
        paths.append(p)

    cfg = GenoConfig(batch_reads=64, max_read_len=128, max_kmers_per_read=4)
    mesh = make_mesh(8)
    names = [f"s{i}" for i in range(n_samples)]
    cohort = CohortRunner(mini_index, names, cfg, mesh=mesh)
    for name, fq in zip(names, paths):
        cohort.consume_sample(name, fq)
    outs = cohort.write_vcfs(os.path.join(FIX, "snps.vcf"),
                             str(tmp_path / "cohort_{sample}.vcf"))

    single_cfg = GenoConfig(batch_reads=512, max_read_len=128,
                            max_kmers_per_read=4)
    for name, fq, out in zip(names, paths, outs):
        r = GenoRunner(mini_index, single_cfg)
        r.consume_fastq(fq)
        ref = str(tmp_path / f"single_{name}.vcf")
        r.write_vcf(os.path.join(FIX, "snps.vcf"), ref)
        assert open(out).read() == open(ref).read(), name
