"""Persistent compilation cache location: JAX_COMPILATION_CACHE_DIR wins
and the package then sets nothing; otherwise the cache is the fixed,
git-ignored <checkout>/.jax_cache (the directory is part of the cache key,
so it must never move between runs)."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("env_dir", [True, False], ids=["env-set", "unset"])
def test_compile_cache_dir(env_dir, tmp_path):
    env = dict(os.environ)
    env.pop("ARAP_NO_COMPILE_CACHE", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    code = ("import jax, arap_flow; "
            "print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    expect = str(tmp_path) if env_dir else str(REPO / ".jax_cache")
    assert r.stdout.strip().splitlines()[-1] == expect
    assert ".jax_cache/" in (REPO / ".gitignore").read_text()
