"""chip_smoke.py's phase functions on the CPU at the mini fixture's size,
and its refusal to run without a GPU. The script itself runs on the card
(``python chip_smoke.py``); the ``gpu`` tests here run its phases there."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

FIX = chip_smoke.FIX


def test_golden_phase_on_cpu(tmp_path):
    chip_smoke.phase_golden(str(tmp_path / "mini"))


def test_spot_parity_phase_on_cpu(tmp_path):
    idx = str(tmp_path / "idx")
    chip_smoke._cli(["index", os.path.join(FIX, "genome.fa"),
                     os.path.join(FIX, "snps.vcf"), idx])
    fq = os.path.join(FIX, "reads.fq")
    runner = chip_smoke._cli_geno(
        [idx, fq, os.path.join(FIX, "snps.vcf"), str(tmp_path / "o.vcf"),
         "--batch-reads", "1024"])
    n_sites = chip_smoke.spot_parity(runner, fq, 300, str(tmp_path))
    assert n_sites == runner.index.sites.pos.shape[0] > 0
    assert sum(int(a.sum()) for a in chip_smoke.host_counts(runner)) > 0
    shutil.rmtree(tmp_path)   # a 1.2 GB Bloom filter


def test_spot_parity_detects_a_mismatch(tmp_path, mini_index):
    from vargeno_tpu.config import GenoConfig
    from vargeno_tpu.engine.geno import GenoRunner

    class Skewed(GenoRunner):
        def _host_counts(self):
            rc, ac = super()._host_counts()
            rc = rc.copy()
            rc[0] += 1
            return rc, ac

    runner = Skewed(mini_index, GenoConfig(batch_reads=512))
    with pytest.raises(AssertionError, match="oracle spot parity"):
        chip_smoke.spot_parity(runner, os.path.join(FIX, "reads.fq"), 64,
                               str(tmp_path))


def test_refuses_cpu_and_prints_no_result():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not a GPU" in out.stderr


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.gpu
def test_golden_phase_on_gpu(gpu_device, tmp_path):
    chip_smoke.phase_golden(str(tmp_path / "mini"))


@pytest.mark.gpu
def test_kernel_phase_on_gpu(gpu_device):
    chip_smoke.phase_kernels()

