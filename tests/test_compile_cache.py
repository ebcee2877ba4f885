"""Where the package puts JAX's persistent compilation cache: wherever
``JAX_COMPILATION_CACHE_DIR`` says (the package then sets nothing), and
otherwise one fixed directory of the checkout, whatever the working
directory."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import chirpgp_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir(cwd, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **env_extra)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_env_variable_wins(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir(ROOT, JAX_COMPILATION_CACHE_DIR=want) == want


def test_default_is_fixed_path_in_checkout():
    assert _cache_dir(ROOT) == os.path.join(ROOT, ".jax_cache")


def test_default_ignores_working_directory(tmp_path):
    assert _cache_dir(str(tmp_path)) == os.path.join(ROOT, ".jax_cache")
