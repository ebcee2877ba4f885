"""``chip_smoke.py`` on the CPU: each phase at a tiny size, and its
refusal to run (and to print a result) without a GPU or outside the
repository."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# Tiny sizes; the accuracy gate only exists at its full record length.
TINY = {
    "mc": lambda: chip_smoke.phase_mc(B=8, T=64, n_ref=4),
    "gate": chip_smoke.phase_gate,
    "fit": lambda: chip_smoke.phase_fit(T=64, max_iters=50, lbfgs_iters=20),
    "grad": lambda: chip_smoke.phase_grad_steps(n_per_mag=2, T=64, iters=3),
    "four": lambda: chip_smoke.phase_four(B=8, T=64, T_long=400),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_checks_pass_at_tiny_size(phase):
    # The script runs with float64 off, as JAX starts; the suite's
    # conftest turns it on globally.
    with jax.enable_x64(False):
        checks = TINY[phase]()
    assert checks, "a phase must check something"
    failed = [c for c in checks if not c.ok]
    assert not failed, failed


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_no_result(out):
    assert out.returncode != 0, out.stdout
    for line in out.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(rec, dict) and rec.get("ok")), line


def test_refuses_without_gpu():
    _assert_no_result(_run(["chip_smoke.py"], ROOT))


def test_refuses_four_without_gpu():
    _assert_no_result(_run(["chip_smoke.py", "--four"], ROOT))


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    _assert_no_result(_run(["chip_smoke.py"], str(tmp_path)))
