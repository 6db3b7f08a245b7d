"""Test configuration: run on a virtual 8-device CPU mesh by default.

Multi-chip sharding logic is validated without accelerator hardware via
``--xla_force_host_platform_device_count`` (see SURVEY.md §4). These env vars
must be set before jax is imported anywhere. Tests marked ``gpu`` need the
card: run them with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``;
elsewhere the ``gpu_device`` fixture skips them.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import gc

import pytest

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "mini")


@pytest.fixture(scope="session")
def mini_index():
    """Built-once index over the mini fixture (cached across test runs)."""
    from vargeno_tpu.config import GenoConfig
    from vargeno_tpu.index import bloom, dictgen, store
    from vargeno_tpu.io import fasta as fasta_io

    cfg = GenoConfig()
    cache = "/tmp/mini_index_test"
    if os.path.exists(cache + ".vgt.npz"):
        return store.load_npz(cache)
    seqs = fasta_io.parse_fasta(os.path.join(FIX, "genome.fa"))
    ref_bf, _ = bloom.build_ref_bfs(seqs, cfg.ref_bf_bits, 64)
    snp_bf = bloom.build_snp_bf(seqs, os.path.join(FIX, "snps.vcf"),
                                cfg.snp_bf_bits)
    snp_dict, locs = dictgen.build_snp_dict_from_vcf(
        seqs, os.path.join(FIX, "snps.vcf"))
    ref_dict, _ = dictgen.build_ref_dict(seqs)
    index = store.VarGenoIndex(
        ref=ref_dict, snp=snp_dict, ref_bf=ref_bf, snp_bf=snp_bf,
        chrlens=[(s.name, s.size) for s in seqs],
        sites=store.derive_sites(snp_dict), snp_locations=locs)
    store.save_npz(cache, index)
    return index


@pytest.fixture(autouse=True)
def _collect_garbage():
    """Runners hold device copies of the index (a 1.2 GB Bloom filter per
    device) inside reference cycles; free them after every test instead of
    whenever the cycle collector next runs."""
    yield
    gc.collect()


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise
    (decided at run time, never while the module is imported)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default JAX device is {dev.platform}; "
                    f"run with JAX_PLATFORMS=cuda)")
    return dev
