"""Where the persistent compile cache goes: JAX_COMPILATION_CACHE_DIR when
it is set (the package then sets nothing), otherwise the checkout's
.jax_cache; CPU processes keep it off."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import plantcaduceus_tpu
from plantcaduceus_tpu import compile_cache_dir

CHECKOUT = Path(plantcaduceus_tpu.__file__).resolve().parent.parent


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/x/cache"}, "/x/cache"),
    ({"JAX_COMPILATION_CACHE_DIR": "/x/cache", "PCAD_PLATFORM": "cpu"},
     "/x/cache"),
    ({}, str(CHECKOUT / ".jax_cache")),
    ({"PCAD_PLATFORM": "gpu"}, str(CHECKOUT / ".jax_cache")),
    ({"PCAD_PLATFORM": "cpu"}, None),
    ({"JAX_PLATFORMS": "cpu"}, None),
])
def test_compile_cache_dir(env, want):
    assert compile_cache_dir(env) == want


def _cache_dir_in_fresh_process(**env_overrides):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "PCAD_PLATFORM",
                        "JAX_PLATFORMS")}
    env.update(env_overrides)
    code = ("import jax, plantcaduceus_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_import_uses_the_variable_when_set(tmp_path):
    got = _cache_dir_in_fresh_process(
        JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert got == str(tmp_path)


def test_import_uses_the_checkout_when_unset():
    assert _cache_dir_in_fresh_process() == str(CHECKOUT / ".jax_cache")
