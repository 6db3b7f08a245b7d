"""Process set-up: the compilation-cache directory and the native host
library's build key."""

import os
import subprocess
import sys

import vargeno_tpu
from vargeno_tpu import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_child(env):
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, vargeno_tpu; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, cwd=REPO, env=env, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_dir_env_unset():
    assert vargeno_tpu.compile_cache_dir({}) == os.path.join(REPO,
                                                             ".jax_cache")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    assert _cache_dir_in_child(env) == os.path.join(REPO, ".jax_cache")


def test_compile_cache_dir_env_set(tmp_path):
    d = str(tmp_path / "xla_cache")
    assert vargeno_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": d}) is None
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=d)
    assert _cache_dir_in_child(env) == d


def test_native_build_key():
    src = b"int f() { return 1; }"
    k = native.build_key(src, cpu="cpu A")
    assert k == native.build_key(src, cpu="cpu A")
    assert k != native.build_key(src + b" ", cpu="cpu A")
    assert k != native.build_key(src, cpu="cpu B")
    assert k != native.build_key(src, cmd=("g++", "-O2"), cpu="cpu A")


def test_native_library_path_is_keyed_build_output():
    path = native.lib_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    with open(os.path.join(os.path.dirname(native.__file__), "fastio.cc"),
              "rb") as f:
        assert native.build_key(f.read()) in os.path.basename(path)
    if native.available():
        assert os.path.exists(path)
