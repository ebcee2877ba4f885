"""Model-layer tests (modeled on reference ``test/test_models.py`` and
``test/test_m32.py``): bijection identities, closed-form discretizations vs
matrix exponentials, LCD vs TME cross-checks, batched-mean consistency."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

from chirpgp_tpu.models import (
    g, g_inv, model_chirp, model_harmonic_chirp, model_lascala,
    disc_chirp_lcd, disc_harmonic_chirp_lcd, disc_model_lascala_lcd,
    disc_m32, m32_solution, stationary_cov_m32, disc_chirp_tme,
    build_chirp_model, build_harmonic_chirp_model, build_lascala_model)
from chirpgp_tpu.utils import lti_sde_to_disc

LAM, B, ELL, SIGMA, DELTA = 0.3, 0.5, 0.8, 1.1, 0.2


def test_bijection_identity():
    xs = jnp.linspace(-5.0, 5.0, 50)
    npt.assert_allclose(g_inv(g(xs)), xs, atol=1e-9)
    ys = jnp.linspace(0.1, 20.0, 50)
    npt.assert_allclose(g(g_inv(ys)), ys, rtol=1e-12)


def test_m32_solution_vs_expm():
    """Closed-form Matern-3/2 transition equals the exact LTI
    discretization (reference ``test/test_m32.py:18-30``)."""
    gamma = math.sqrt(3.0) / ELL
    A = jnp.array([[0.0, 1.0], [-gamma ** 2, -2.0 * gamma]])
    Bm = jnp.array([[0.0, 0.0], [0.0, 2.0 * SIGMA * gamma ** 1.5]])
    for dt in [1e-3, 1e-2, 0.1, 1.0]:
        F_exact, Sigma_exact = lti_sde_to_disc(A, Bm, dt)
        F, Sigma = m32_solution(ELL, SIGMA, dt)
        npt.assert_allclose(F, F_exact, rtol=1e-8, atol=1e-12)
        npt.assert_allclose(Sigma, Sigma_exact, rtol=1e-6, atol=1e-12)


def test_m32_stationarity():
    """Stationary covariance is preserved: F P_inf F^T + Sigma = P_inf."""
    P_inf = stationary_cov_m32(ELL, SIGMA)
    F, Sigma = m32_solution(ELL, SIGMA, 0.37)
    npt.assert_allclose(F @ P_inf @ F.T + Sigma, P_inf, rtol=1e-8, atol=1e-12)


def test_chirp_lcd_vs_expm_frozen_frequency():
    """With the frequency frozen at g(V), the chirp-block LCD equals the
    exact discretization of the corresponding LTI SDE (reference
    ``test/test_models.py:29-51``)."""
    u = jnp.array([0.4, -0.7, 0.9, 0.1])
    w = 2.0 * math.pi * float(g(u[2]))
    dt = 0.01
    A = jnp.array([[-LAM, -w], [w, -LAM]])
    Bm = B * jnp.eye(2)
    F_exact, Sigma_exact = lti_sde_to_disc(A, Bm, dt)

    trans = disc_chirp_lcd(LAM, B, ELL, SIGMA)
    m, cov = trans(u, dt)
    npt.assert_allclose(m[:2], F_exact @ u[:2], rtol=1e-8)
    npt.assert_allclose(cov[:2, :2], Sigma_exact, rtol=1e-6, atol=1e-12)
    # Matern block
    F32, S32 = m32_solution(ELL, SIGMA, dt)
    npt.assert_allclose(m[2:], F32 @ u[2:], rtol=1e-10)
    npt.assert_allclose(cov[2:, 2:], S32, rtol=1e-10)


def test_chirp_lcd_zero_damping_smooth():
    """lam = 0 gives variance b^2 dt without a cond branch, and the lam
    gradient is finite (the reference's lax.cond is not differentiable
    there)."""
    dt = 0.05
    u = jnp.array([1.0, 0.0, 0.5, 0.0])
    trans = disc_chirp_lcd(0.0, B, ELL, SIGMA)
    _, cov = trans(u, dt)
    npt.assert_allclose(cov[0, 0], B ** 2 * dt, rtol=1e-9)

    def q_of_lam(lam):
        return disc_chirp_lcd(lam, B, ELL, SIGMA)(u, dt)[1][0, 0]

    grad = jax.grad(q_of_lam)(0.0)
    assert np.isfinite(grad)
    # Finite-difference check
    eps = 1e-6
    fd = (q_of_lam(eps) - q_of_lam(-eps)) / (2 * eps)
    npt.assert_allclose(grad, fd, rtol=1e-4)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_harmonic_lcd_vs_expm(K):
    """Harmonic-chirp LCD vs exact LTI discretization for K harmonics
    (reference ``test/test_models.py:53-78``)."""
    d = 2 * K + 2
    u = jnp.arange(1.0, d + 1.0) / d
    dt = 0.01
    w = 2.0 * math.pi * float(g(u[-2]))
    trans = disc_harmonic_chirp_lcd(LAM, B, ELL, SIGMA, num_harmonics=K)
    m, cov = trans(u, dt)
    for k in range(1, K + 1):
        A = jnp.array([[-LAM, -k * w], [k * w, -LAM]])
        F_exact, Sigma_exact = lti_sde_to_disc(A, B * jnp.eye(2), dt)
        sl = slice(2 * (k - 1), 2 * k)
        npt.assert_allclose(m[sl], F_exact @ u[sl], rtol=1e-8)
        npt.assert_allclose(cov[sl, sl], Sigma_exact, rtol=1e-6, atol=1e-12)


def test_harmonic_reduces_to_chirp():
    """K=1 harmonic model equals the plain chirp model."""
    u = jnp.array([0.4, -0.7, 0.9, 0.1])
    dt = 0.02
    m1, c1 = disc_chirp_lcd(LAM, B, ELL, SIGMA)(u, dt)
    m2, c2 = disc_harmonic_chirp_lcd(LAM, B, ELL, SIGMA, num_harmonics=1)(u, dt)
    npt.assert_allclose(m1, m2, rtol=1e-12)
    npt.assert_allclose(c1, c2, rtol=1e-12)


@pytest.mark.slow
def test_lcd_vs_tme_small_dt():
    """LCD and TME order-3 agree at small dt (reference
    ``test/test_models.py:92-100``)."""
    u = jnp.array([0.2, 0.8, 0.4, -0.1])
    dt = 1e-3
    m_lcd, cov_lcd = disc_chirp_lcd(LAM, B, ELL, SIGMA)(u, dt)
    m_tme, cov_tme = disc_chirp_tme(LAM, B, ELL, SIGMA, order=3)(u, dt)
    npt.assert_allclose(m_lcd, m_tme, atol=1e-5)
    npt.assert_allclose(cov_lcd, cov_tme, atol=1e-5)


def test_tme_exact_on_lti():
    """On the (linear) Matern-3/2 SDE, TME order-3 matches the exact
    discretization to O(dt^4)."""
    from chirpgp_tpu.models.tme import disc_tme
    gamma = math.sqrt(3.0) / ELL

    def drift(u):
        return jnp.stack([u[..., 1],
                          -(gamma ** 2) * u[..., 0] - 2.0 * gamma * u[..., 1]],
                         axis=-1)

    def dispersion(_):
        return jnp.array([[0.0, 0.0], [0.0, 2.0 * SIGMA * gamma ** 1.5]])

    u = jnp.array([0.3, -0.2])
    for dt, rtol in [(1e-3, 1e-2), (1e-2, 5e-2)]:
        m_tme, cov_tme = disc_tme(drift, dispersion, order=3)(u, dt)
        F, Sigma = m32_solution(ELL, SIGMA, dt)
        npt.assert_allclose(m_tme, F @ u, rtol=1e-6, atol=1e-10)
        # Covariance entries are O(dt)..O(dt^3); truncation leaves O(dt^4),
        # so the relative error shrinks like dt.
        npt.assert_allclose(cov_tme, Sigma, rtol=rtol, atol=1e-12)


def test_batched_mean_matches_pointwise():
    """The batched LCD mean equals per-point evaluation (the batched fast
    path is exact, not approximate)."""
    trans = disc_chirp_lcd(LAM, B, ELL, SIGMA)
    key = jax.random.PRNGKey(3)
    chi = jax.random.normal(key, (81, 4))
    dt = 0.01
    batched = trans.mean(chi, dt)
    pointwise = jnp.stack([trans.mean(chi[i], dt) for i in range(81)])
    npt.assert_allclose(batched, pointwise, rtol=1e-12)

    transH = disc_harmonic_chirp_lcd(LAM, B, ELL, SIGMA, num_harmonics=3)
    chiH = jax.random.normal(key, (16, 8))
    batchedH = transH.mean(chiH, dt)
    pointwiseH = jnp.stack([transH.mean(chiH[i], dt) for i in range(16)])
    npt.assert_allclose(batchedH, pointwiseH, rtol=1e-12)


def test_drift_dispersion_shapes():
    for model, d in [(model_chirp(LAM, B, ELL, SIGMA, DELTA), 4),
                     (model_harmonic_chirp(LAM, B, ELL, SIGMA, DELTA, 3), 8),
                     (model_lascala(ELL, SIGMA, DELTA), 4)]:
        drift, dispersion, m0, P0, H = model
        assert m0.shape == (d,)
        assert P0.shape == (d, d)
        assert H.shape == (d,)
        assert drift(m0).shape == (d,)
        assert dispersion(m0).shape == (d, d)
        # batched drift
        batch = jnp.stack([m0, m0 + 0.1])
        npt.assert_allclose(drift(batch)[0], drift(m0), rtol=1e-12)


def test_builders():
    params = jnp.array([LAM, B, DELTA, ELL, SIGMA, 0.7])
    drift, dispersion, m_and_cov, m0, P0, H = build_chirp_model(params)
    npt.assert_allclose(m0, jnp.array([0.0, 0.0, 0.7, 0.0]))
    m, cov = m_and_cov(m0, 0.01)
    assert m.shape == (4,) and cov.shape == (4, 4)

    packH = build_harmonic_chirp_model(params, num_harmonics=2, freq_scale=10.0)
    npt.assert_allclose(packH.m0, jnp.array([0.0, 1.0, 0.0, 1.0, 0.7, 0.0]))

    packL = build_lascala_model(jnp.array([DELTA, ELL, SIGMA, 0.7]))
    npt.assert_allclose(packL.m0, jnp.array([0.0, 0.0, 0.7, 0.0]))
    # La Scala chirp block is noise-free
    npt.assert_allclose(packL.m_and_cov(packL.m0, 0.01)[1][:2, :2], 0.0)
