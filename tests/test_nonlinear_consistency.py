"""Nonlinear / chaotic-dynamics consistency tests.

1. EKF vs CD-EKF agreement on a stochastic Lorenz system (reference
   ``test/test_ekfs.py:11-62``: discrete-time EKF on the TME-2
   discretization must track the continuous-discrete moment-ODE EKF on a
   chaotic nonlinear drift, rtol 0.2).
2. A production-shape float32 finite-difference gradient check through the
   remat'd square-root filter at T=3141 (the production MLE gradient
   path), run in a subprocess so the suite's global x64 config doesn't
   mask f32 behavior.
"""

import math
import subprocess
import sys

import pytest
import jax
import jax.numpy as jnp
import numpy.testing as npt

from chirpgp_tpu.infer import ekf, eks, cd_ekf, cd_eks
from chirpgp_tpu.models.tme import disc_tme
from chirpgp_tpu.utils import simulate_sde

KAPPA, LAM, MU = 10.0, 28.0, 2.0


def _lorenz():
    def drift(u):
        return jnp.array([KAPPA * (u[1] - u[0]),
                          u[0] * (LAM - u[2]) - u[1],
                          u[0] * u[1] - MU * u[2]])

    def dispersion(_):
        return 5.0 * jnp.eye(3)

    return drift, dispersion


def test_ekf_vs_cd_ekf_on_stochastic_lorenz():
    drift, dispersion = _lorenz()
    trans = disc_tme(drift, dispersion, order=2)

    dt, T, Xi = 1e-3, 2000, 2.0
    H = jnp.array([1.0, 0.0, 0.0])
    m0 = jnp.zeros(3)
    P0 = jnp.eye(3)

    key = jax.random.PRNGKey(666)
    traj = simulate_sde(trans, m0, P0, dt, T, key)
    key, _ = jax.random.split(key)
    ys = traj[:, 0] + math.sqrt(Xi) * jax.random.normal(key, (T,))

    mfs, Pfs, nell = jax.jit(lambda y: ekf(trans, H, Xi, m0, P0, dt, y))(ys)
    cd_mfs, cd_Pfs, cd_nell = jax.jit(
        lambda y: cd_ekf(drift, dispersion, H, Xi, m0, P0, dt, y))(ys)

    # rtol as in the reference; atol covers entries that are exactly 0 in
    # one discretization and O(roundoff) in the other.
    npt.assert_allclose(mfs, cd_mfs, rtol=0.2, atol=1e-3)
    npt.assert_allclose(Pfs, cd_Pfs, rtol=0.21, atol=1e-3)
    npt.assert_allclose(nell, cd_nell, rtol=1e-5, atol=1e-2)

    # Smoothers agree loosely too (not asserted in the reference; keep a
    # weak sanity bound on the final smoothed state).
    mss, _ = eks(trans, mfs, Pfs, dt)
    cd_mss, _ = cd_eks(drift, dispersion, cd_mfs, cd_Pfs, dt)
    npt.assert_allclose(mss[-1], cd_mss[-1], rtol=0.2)
    assert bool(jnp.all(jnp.isfinite(mss)))


_GRAD_CHECK_SCRIPT = r"""
import math
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from chirpgp_tpu.apps import IFEstimationConfig, make_nll_fn
from chirpgp_tpu.models import g_inv
from chirpgp_tpu.toymodels import gen_chirp, constant_mag, meow_freq

dt, T, Xi = 1e-3, 3141, 0.1
ts = jnp.linspace(dt, dt * T, T, dtype=jnp.float32)
_, phase = meow_freq(offset=8.0)
ys = (gen_chirp(ts, constant_mag(1.0), phase)
      + math.sqrt(Xi) * jax.random.normal(jax.random.PRNGKey(7), (T,))
      ).astype(jnp.float32)

cfg = IFEstimationConfig(method="ghfs", form="sqrt")
nll = make_nll_fn(cfg, ys)
theta = g_inv(jnp.array([0.1, 0.1, 0.1, 1.0, 1.0, 7.0],
                        dtype=jnp.float32))
val = jax.jit(nll)(theta)
grad = jax.jit(jax.grad(nll))(theta)
assert val.dtype == jnp.float32, val.dtype
assert grad.dtype == jnp.float32, grad.dtype

# Central finite differences per component.  f32 NLL at T=3141 has
# roundoff ~1e-3 in a ~1e3-magnitude objective, so use a large step and
# a loose tolerance: this guards against *structurally* wrong gradients
# (sign flips, missing terms through the QR/remat path), not ulps.
eps = 3e-3
gmax = float(jnp.max(jnp.abs(grad)))
for i in range(theta.shape[0]):
    e = jnp.zeros_like(theta).at[i].set(eps)
    fd = (nll(theta + e) - nll(theta - e)) / (2 * eps)
    ad = grad[i]
    denom = max(abs(float(fd)), abs(float(ad)), 1.0)
    rel = abs(float(fd) - float(ad)) / denom
    # Components much smaller than the gradient scale drown in the f32
    # objective's roundoff (the FD numerator cancels ~7 digits); accept
    # them on an absolute criterion tied to the gradient norm instead.
    ok = rel < 0.08 or abs(float(fd) - float(ad)) < 0.02 * gmax
    print(f"component {i}: ad={float(ad):.4f} fd={float(fd):.4f} "
          f"rel={rel:.4f} ok={ok}")
    assert ok, (i, float(ad), float(fd))
print("OK")
"""


@pytest.mark.slow
def test_f32_gradient_through_remat_sqrt_filter_T3141():
    """jax.grad through the remat'd sqrt GHFS filter matches central
    finite differences in pure float32 at the production shape."""
    res = subprocess.run(
        [sys.executable, "-c", _GRAD_CHECK_SCRIPT],
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "OK" in res.stdout
