"""Batched channels-first kernels: exact equivalence with the per-seed
sqrt filters/smoothers."""

import math

import pytest
import jax
import jax.numpy as jnp
import numpy.testing as npt

from chirpgp_tpu.infer import sqrt_sgp_filter, sqrt_sgp_smoother
from chirpgp_tpu.infer.batched import (
    tria_cf, sqrt_sgp_filter_batched, sqrt_sgp_smoother_batched,
    gaussian_expectation_batched)
from chirpgp_tpu.models import g, g_inv, build_chirp_model
from chirpgp_tpu.quad import gauss_hermite, gaussian_expectation_1d
from chirpgp_tpu.toymodels import gen_chirp, constant_mag, meow_freq


def _chirp_setup(B=3, T=120):
    dt, Xi = 1e-3, 0.1
    ts = jnp.linspace(dt, dt * T, T)
    _, phase = meow_freq(offset=8.0)
    base = gen_chirp(ts, constant_mag(1.0), phase)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    yss = base[None] + math.sqrt(Xi) * jax.vmap(
        lambda k: jax.random.normal(k, (T,)))(keys)
    params = g(g_inv(jnp.array([0.1, 0.1, 0.1, 1.0, 1.0, 7.0])))
    pack = build_chirp_model(params)
    return dt, Xi, yss, pack


def test_tria_cf_matches_tria():
    from chirpgp_tpu.infer import tria
    M = jax.random.normal(jax.random.PRNGKey(1), (20, 4, 5))
    R_cf = tria_cf(M)
    for b in range(5):
        R = tria(M[:, :, b], "hh")
        npt.assert_allclose(R_cf[:, :, b], R, rtol=1e-10, atol=1e-12)


def test_batched_filter_matches_per_seed():
    dt, Xi, yss, pack = _chirp_setup()
    rule = gauss_hermite(4, order=3)
    mfs_b, Lfs_b, nll_b = sqrt_sgp_filter_batched(
        pack.m_and_cov, rule, pack.H, Xi, pack.m0, pack.P0, dt, yss)
    for b in range(yss.shape[0]):
        mfs, Lfs, nll = sqrt_sgp_filter(pack.m_and_cov, rule, pack.H, Xi,
                                        pack.m0, pack.P0, dt, yss[b])
        npt.assert_allclose(mfs_b[:, :, b], mfs, rtol=1e-8, atol=1e-10)
        npt.assert_allclose(nll_b[:, b], nll, rtol=1e-8)
        # Factors agree as covariances (signs may differ).
        P_b = jnp.einsum("tikb,tjkb->tijb", Lfs_b, Lfs_b)[..., b]
        P = Lfs @ jnp.swapaxes(Lfs, -1, -2)
        npt.assert_allclose(P_b, P, rtol=1e-7, atol=1e-11)


@pytest.mark.slow
def test_batched_smoother_matches_per_seed():
    dt, Xi, yss, pack = _chirp_setup()
    rule = gauss_hermite(4, order=3)
    mfs_b, Lfs_b, _ = sqrt_sgp_filter_batched(
        pack.m_and_cov, rule, pack.H, Xi, pack.m0, pack.P0, dt, yss)
    mss_b, Lss_b = sqrt_sgp_smoother_batched(pack.m_and_cov, rule,
                                             mfs_b, Lfs_b, dt)
    for b in range(yss.shape[0]):
        mfs, Lfs, _ = sqrt_sgp_filter(pack.m_and_cov, rule, pack.H, Xi,
                                      pack.m0, pack.P0, dt, yss[b])
        mss, Lss = sqrt_sgp_smoother(pack.m_and_cov, rule, mfs, Lfs, dt)
        npt.assert_allclose(mss_b[:, :, b], mss, rtol=1e-6, atol=1e-8)
        P_b = jnp.einsum("tikb,tjkb->tijb", Lss_b, Lss_b)[..., b]
        P = Lss @ jnp.swapaxes(Lss, -1, -2)
        npt.assert_allclose(P_b, P, rtol=1e-5, atol=1e-9)


def test_batched_expectation_matches_1d():
    ms = jax.random.normal(jax.random.PRNGKey(2), (50, 4))
    stds = jnp.abs(jax.random.normal(jax.random.PRNGKey(3), (50, 4))) + 0.1
    out = gaussian_expectation_batched(ms, stds)
    for b in range(4):
        ref = gaussian_expectation_1d(ms[:, b], stds[:, b])
        npt.assert_allclose(out[:, b], ref, rtol=1e-10)


def test_fused_filter_smoother_matches_separate():
    """The fused joint-triangularization path reproduces the separate
    filter-then-smoother path exactly (same Gram algebra)."""
    from chirpgp_tpu.infer.batched import sqrt_sgp_filter_smoother_batched

    dt, Xi, yss, pack = _chirp_setup(B=4, T=90)
    rule = gauss_hermite(4, 3)
    args = (pack.m_and_cov, rule, pack.H, Xi, pack.m0, pack.P0, dt, yss)
    mfs, Lfs, nll = sqrt_sgp_filter_batched(*args)
    mss, Lss = sqrt_sgp_smoother_batched(pack.m_and_cov, rule, mfs, Lfs, dt)
    mss2, Lss2, nll2 = sqrt_sgp_filter_smoother_batched(*args)
    npt.assert_allclose(nll2, nll, rtol=1e-9, atol=1e-10)
    npt.assert_allclose(mss2, mss, rtol=1e-7, atol=1e-9)
    P1 = jnp.einsum("tikb,tjkb->tijb", Lss, Lss)
    P2 = jnp.einsum("tikb,tjkb->tijb", Lss2, Lss2)
    npt.assert_allclose(P2, P1, rtol=1e-6, atol=1e-9)


def test_slim_output_matches_full():
    """``out_index`` slim output is bit-equal to the corresponding
    slices of the full covariance-branch output (same backward carry,
    only the emitted rows differ)."""
    from chirpgp_tpu.infer.batched import sqrt_sgp_filter_smoother_batched

    dt, Xi, yss, pack = _chirp_setup(B=4, T=90)
    rule = gauss_hermite(4, 3)
    args = (pack.m_and_cov, rule, pack.H, Xi, pack.m0, pack.P0, dt, yss)
    mss, Pss, nll = sqrt_sgp_filter_smoother_batched(
        *args, return_factors=False)
    v_mean, v_var, nll2 = sqrt_sgp_filter_smoother_batched(
        *args, return_factors=False, out_index=2)
    npt.assert_array_equal(nll2, nll)
    npt.assert_array_equal(v_mean, mss[:, 2, :])
    npt.assert_array_equal(v_var, Pss[:, 2, 2, :])

    with pytest.raises(ValueError):
        sqrt_sgp_filter_smoother_batched(*args, out_index=2)


def test_cov_filter_smoother_matches_sqrt():
    """The covariance-form fused path reproduces the sqrt path (f64)."""
    from chirpgp_tpu.infer.batched import (
        sqrt_sgp_filter_smoother_batched, cov_sgp_filter_smoother_batched)

    dt, Xi, yss, pack = _chirp_setup(B=4, T=90)
    rule = gauss_hermite(4, 3)
    args = (pack.m_and_cov, rule, pack.H, Xi, pack.m0, pack.P0, dt, yss)
    mss, Lss, nll = sqrt_sgp_filter_smoother_batched(*args)
    Pss_sqrt = jnp.einsum("tikb,tjkb->tijb", Lss, Lss)
    mss2, Pss2, nll2 = cov_sgp_filter_smoother_batched(*args)
    npt.assert_allclose(nll2, nll, rtol=1e-9, atol=1e-9)
    npt.assert_allclose(mss2, mss, rtol=1e-7, atol=1e-9)
    npt.assert_allclose(Pss2, Pss_sqrt, rtol=1e-6, atol=1e-9)
