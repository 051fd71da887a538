"""Where the package puts JAX's persistent compilation cache: the directory
JAX_COMPILATION_CACHE_DIR names when it is set, otherwise a fixed path in
the checkout. Each case imports the package in a fresh process."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax, baryonforge_tpu; "
         "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return res.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_value, expected", [
    ("/nonexistent/bfg-cache", "/nonexistent/bfg-cache"),
    (None, os.path.join(REPO, ".jax_cache")),
], ids=["variable-set", "default-in-checkout"])
def test_compile_cache_directory(env_value, expected):
    assert _cache_dir(env_value) == expected
