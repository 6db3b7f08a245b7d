"""vargeno_tpu: an accelerator-native, alignment-free SNP genotyping framework.

A from-scratch JAX/XLA redesign with the capabilities of
medvedevgroup/vargeno: `index` builds 32-mer reference/SNP dictionaries and
Bloom filters from FASTA+VCF; `geno` streams FASTQ reads in fixed-shape
batches through a batched device lookup/vote/pileup engine and writes GT/GQ
calls into the input VCF.
"""

__version__ = "0.1.0"

import os as _os

# fixed in-repo cache path: the path is part of the cache's key, so it must
# not move between processes
REPO_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ=_os.environ):
    """The directory this package points JAX's persistent compilation cache
    at, or None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads
    that directory itself and the package sets no other)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


def _enable_compilation_cache() -> None:
    """Persistent XLA compilation cache: the engine's batch step takes
    tens of seconds to compile at production shapes, and a cached
    executable loads in seconds in every later process."""
    path = compile_cache_dir()
    if path is None:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", path)


_enable_compilation_cache()

from .config import DEFAULT_CONFIG, GenoConfig  # noqa: F401
