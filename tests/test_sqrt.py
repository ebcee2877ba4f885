"""Square-root filter/smoother tests: exact equivalence with the
covariance forms in float64, and stability on the canonical chirp config
in float32 (where the covariance-form smoother is known to lose PSD)."""

import math

import jax
import jax.numpy as jnp
import numpy.testing as npt
import pytest

from chirpgp_tpu.infer import (
    kf, rts, ekf, eks, sgp_filter, sgp_smoother,
    sqrt_kf, sqrt_ekf, sqrt_eks, sqrt_sgp_filter, sqrt_sgp_smoother)
from chirpgp_tpu.models import (
    g, g_inv, build_chirp_model, m32_solution, stationary_cov_m32, disc_m32)
from chirpgp_tpu.quad import cubature, gauss_hermite
from chirpgp_tpu.utils import simulate_lgssm

ELL, SIGMA, DT, XI, T = 0.7, 1.2, 0.01, 0.05, 150


def _lgssm_data():
    F, Sigma = m32_solution(ELL, SIGMA, DT)
    H = jnp.array([1.0, 0.0])
    m0 = jnp.zeros(2)
    P0 = stationary_cov_m32(ELL, SIGMA)
    key = jax.random.PRNGKey(42)
    xs = simulate_lgssm(F, Sigma, m0, T, key)
    key, sub = jax.random.split(key)
    ys = xs @ H + math.sqrt(XI) * jax.random.normal(sub, (T,))
    return F, Sigma, H, m0, P0, ys


def _covs(Ls):
    return Ls @ jnp.swapaxes(Ls, -1, -2)


def test_sqrt_kf_matches_kf():
    F, Sigma, H, m0, P0, ys = _lgssm_data()
    mfs, Pfs, nell = kf(F, Sigma, H, XI, m0, P0, ys)
    mfs2, Lfs, nell2 = sqrt_kf(F, Sigma, H, XI, m0, P0, ys)
    npt.assert_allclose(mfs2, mfs, rtol=1e-8, atol=1e-11)
    npt.assert_allclose(_covs(Lfs), Pfs, rtol=1e-8, atol=1e-12)
    npt.assert_allclose(nell2, nell, rtol=1e-9)


def test_sqrt_sgp_matches_cov_form():
    _, _, H, m0, P0, ys = _lgssm_data()
    trans = disc_m32(ELL, SIGMA)
    rule = gauss_hermite(2, order=3)
    mfs, Pfs, nell = sgp_filter(trans, rule, H, XI, m0, P0, DT, ys)
    mfs2, Lfs, nell2 = sqrt_sgp_filter(trans, rule, H, XI, m0, P0, DT, ys)
    npt.assert_allclose(mfs2, mfs, rtol=1e-7, atol=1e-10)
    npt.assert_allclose(_covs(Lfs), Pfs, rtol=1e-7, atol=1e-11)
    npt.assert_allclose(nell2, nell, rtol=1e-8)

    mss, Pss = sgp_smoother(trans, rule, mfs, Pfs, DT)
    mss2, Lss = sqrt_sgp_smoother(trans, rule, mfs2, Lfs, DT)
    npt.assert_allclose(mss2, mss, rtol=1e-6, atol=1e-9)
    npt.assert_allclose(_covs(Lss), Pss, rtol=1e-6, atol=1e-10)


def test_sqrt_ekf_eks_match_cov_form():
    _, _, H, m0, P0, ys = _lgssm_data()
    trans = disc_m32(ELL, SIGMA)
    mfs, Pfs, nell = ekf(trans, H, XI, m0, P0, DT, ys)
    mfs2, Lfs, nell2 = sqrt_ekf(trans, H, XI, m0, P0, DT, ys)
    npt.assert_allclose(mfs2, mfs, rtol=1e-8, atol=1e-11)
    npt.assert_allclose(_covs(Lfs), Pfs, rtol=1e-7, atol=1e-12)
    npt.assert_allclose(nell2, nell, rtol=1e-8)

    mss, Pss = eks(trans, mfs, Pfs, DT)
    mss2, Lss = sqrt_eks(trans, mfs2, Lfs, DT)
    npt.assert_allclose(mss2, mss, rtol=1e-6, atol=1e-9)
    npt.assert_allclose(_covs(Lss), Pss, rtol=1e-6, atol=1e-10)


def test_sqrt_chirp_f32_stays_finite():
    """The float32 sqrt pipeline stays finite on the canonical chirp config
    where the covariance-form smoother produces negative variances (this is
    the float32 production path; here exercised on the CPU)."""
    from chirpgp_tpu.toymodels import gen_chirp, constant_mag, meow_freq

    dt, T_, Xi = 1e-3, 3141, 0.1
    ts = jnp.linspace(dt, dt * T_, T_).astype(jnp.float32)
    _, phase = meow_freq(offset=8.0)
    key = jax.random.PRNGKey(999)
    ys = (gen_chirp(ts, constant_mag(1.0), phase)
          + math.sqrt(Xi) * jax.random.normal(key, (T_,))).astype(jnp.float32)

    params = g(g_inv(jnp.array([0.1, 0.1, 0.1, 1.0, 1.0, 7.0]))).astype(
        jnp.float32)
    pack = build_chirp_model(params)
    rule = gauss_hermite(4, order=3)
    mfs, Lfs, nell = sqrt_sgp_filter(
        pack.m_and_cov, rule, pack.H.astype(jnp.float32), jnp.float32(Xi),
        pack.m0.astype(jnp.float32),
        pack.P0.astype(jnp.float32), jnp.float32(dt), ys)
    assert mfs.dtype == jnp.float32
    mss, Lss = sqrt_sgp_smoother(pack.m_and_cov, rule, mfs, Lfs,
                                 jnp.float32(dt))
    assert bool(jnp.all(jnp.isfinite(mss)))
    vars_v = jnp.sum(Lss[:, 2, :] ** 2, axis=-1)
    assert bool(jnp.all(vars_v > 0))


def test_m32_sigma_f32_accuracy():
    """The float32 Matern-3/2 noise covariance agrees with the float64
    closed form to fine relative accuracy (regression test for the
    catastrophic-cancellation fix in ``_sigma11_factor``)."""
    _, S64 = m32_solution(1.0, 1.0, 1e-3)
    _, S32 = m32_solution(jnp.float32(1.0), jnp.float32(1.0),
                          jnp.float32(1e-3))
    npt.assert_allclose(jnp.asarray(S32, jnp.float64), S64, rtol=1e-5)


def test_sqrt_filter_handles_singular_process_noise_lascala():
    """The La Scala model's conditional covariance is exactly singular
    (no dispersion on the chirp block, reference ``models.py:181``);
    the sqrt filters must produce finite results via the degenerate-safe
    psd_cholesky rather than NaN (round-2 regression)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chirpgp_tpu.models import build_lascala_model, g, g_inv
    from chirpgp_tpu.infer import sqrt_sgp_filter, sqrt_sgp_smoother
    from chirpgp_tpu.quad import gauss_hermite
    from chirpgp_tpu.utils.numerics import psd_cholesky

    params = g(g_inv(jnp.array([0.1, 1.0, 1.0, 7.0])))
    pack = build_lascala_model(params)
    # psd_cholesky reproduces the singular covariance exactly.
    _, C = pack.m_and_cov(pack.m0, 1e-3)
    L = psd_cholesky(C)
    np.testing.assert_allclose(np.asarray(L @ L.T), np.asarray(C),
                               atol=1e-12)

    ys = 0.3 * jax.random.normal(jax.random.PRNGKey(3), (200,))
    sgps = gauss_hermite(4, 3)
    mfs, Lfs, nll = sqrt_sgp_filter(pack.m_and_cov, sgps, pack.H, 0.1,
                                    pack.m0, pack.P0, 1e-3, ys)
    assert bool(jnp.all(jnp.isfinite(mfs)))
    assert bool(jnp.isfinite(nll[-1]))
    mss, Lss = sqrt_sgp_smoother(pack.m_and_cov, sgps, mfs, Lfs, 1e-3)
    assert bool(jnp.all(jnp.isfinite(mss)))


def test_psd_solve_pd_and_singular():
    """psd_solve equals the Cholesky solve on PD inputs and acts as the
    pseudo-inverse on the degenerate subspace of singular PSD inputs
    (the cov-form smoother gain on La Scala-type models, round-2 fix)."""
    import jax.numpy as jnp
    import numpy as np

    from chirpgp_tpu.utils.numerics import psd_solve

    rng = np.random.default_rng(0)
    A = rng.normal(size=(4, 4))
    P = A @ A.T + 4 * np.eye(4)
    B = rng.normal(size=(4, 3))
    X = psd_solve(jnp.asarray(P), jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(X), np.linalg.solve(P, B),
                               rtol=1e-9)
    # vector RHS
    x = psd_solve(jnp.asarray(P), jnp.asarray(B[:, 0]))
    np.testing.assert_allclose(np.asarray(x),
                               np.linalg.solve(P, B[:, 0]), rtol=1e-9)

    # Singular: rank-2 PSD in 4-d.  P P^+ B == B for B in range(P).
    U = rng.normal(size=(4, 2))
    Ps = U @ U.T
    Bs = Ps @ rng.normal(size=(4, 2))          # in range(P)
    Xs = np.asarray(psd_solve(jnp.asarray(Ps), jnp.asarray(Bs)))
    assert np.all(np.isfinite(Xs))
    np.testing.assert_allclose(Ps @ Xs, Bs, atol=1e-8)


def test_cov_smoother_finite_on_lascala():
    """Covariance-form sigma-point filter+smoother stay finite on the
    La Scala model (f32-indefinite covariances; psd_solve/psd_cholesky
    paths) -- the estimate step clamps negative marginal variances."""
    import jax
    import jax.numpy as jnp

    from chirpgp_tpu.models import build_lascala_model, g, g_inv
    from chirpgp_tpu.infer import sgp_filter, sgp_smoother
    from chirpgp_tpu.quad import gauss_hermite

    params = g(g_inv(jnp.array([0.1, 1.0, 1.0, 7.0])))
    pack = build_lascala_model(params)
    ys = 0.3 * jax.random.normal(jax.random.PRNGKey(3), (300,))
    sgps = gauss_hermite(4, 3)
    mfs, Pfs, nll = sgp_filter(pack.m_and_cov, sgps, pack.H, 0.1,
                               pack.m0, pack.P0, 1e-3, ys)
    mss, Pss = sgp_smoother(pack.m_and_cov, sgps, mfs, Pfs, 1e-3)
    assert bool(jnp.all(jnp.isfinite(mss)))
    assert bool(jnp.isfinite(nll[-1]))


def test_scan_unroll_is_bit_identical():
    """``unroll`` must be a pure perf knob: same ops in the same order,
    so filter outputs (and hence sweep results / parity artifacts) are
    bit-identical at any unroll value."""
    params = g(g_inv(jnp.array([0.1, 0.1, 0.1, 1.0, 1.0, 7.0])))
    pack = build_chirp_model(params)
    sgps = gauss_hermite(4, order=3)
    key = jax.random.PRNGKey(7)
    ys = jax.random.normal(key, (97,))   # deliberately not a multiple of 4
    for fn in (
        lambda u: sqrt_sgp_filter(pack.m_and_cov, sgps, pack.H, XI,
                                  pack.m0, pack.P0, DT, ys, unroll=u),
        lambda u: sqrt_ekf(pack.m_and_cov, pack.H, XI, pack.m0, pack.P0,
                           DT, ys, unroll=u),
    ):
        ref = jax.jit(lambda: fn(1))()
        out = jax.jit(lambda: fn(4))()
        for a, b in zip(ref, out):
            npt.assert_array_equal(jax.device_get(a), jax.device_get(b))
