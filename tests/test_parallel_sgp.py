"""Tests for the iterated parallel sigma-point filter/smoother: exact
equivalence with KF/RTS on linear models and accuracy parity with the
sequential SGP smoother on the chirp model."""

import math

import pytest
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt

from chirpgp_tpu.infer import kf, rts, sgp_filter, sgp_smoother
from chirpgp_tpu.infer.parallel_sgp import (
    kf_parallel_tv, rts_parallel_tv, slr_transitions, psgp_filter_smoother)
from chirpgp_tpu.models import (
    g, g_inv, build_chirp_model, m32_solution, stationary_cov_m32, disc_m32)
from chirpgp_tpu.quad import cubature, gauss_hermite
from chirpgp_tpu.toymodels import gen_chirp, constant_mag, meow_freq
from chirpgp_tpu.utils import simulate_lgssm, rmse

ELL, SIGMA, DT, XI, T = 0.7, 1.2, 0.01, 0.05, 150


def _lgssm():
    F, Sigma = m32_solution(ELL, SIGMA, DT)
    H = jnp.array([1.0, 0.0])
    m0 = jnp.zeros(2)
    P0 = stationary_cov_m32(ELL, SIGMA)
    key = jax.random.PRNGKey(11)
    xs = simulate_lgssm(F, Sigma, m0, T, key)
    key, sub = jax.random.split(key)
    ys = xs @ H + math.sqrt(XI) * jax.random.normal(sub, (T,))
    return F, Sigma, H, m0, P0, ys


@pytest.mark.slow
def test_tv_parallel_equals_kf_rts_on_lti():
    F, Sigma, H, m0, P0, ys = _lgssm()
    mfs, Pfs, nll = kf(F, Sigma, H, XI, m0, P0, ys)
    mss, Pss = rts(F, Sigma, mfs, Pfs)

    Fs = jnp.broadcast_to(F, (T, 2, 2))
    cs = jnp.zeros((T, 2))
    Sig = jnp.broadcast_to(Sigma, (T, 2, 2))
    mfs2, Pfs2, nll2 = kf_parallel_tv(Fs, cs, Sig, H, XI, m0, P0, ys)
    npt.assert_allclose(mfs2, mfs, rtol=1e-8, atol=1e-11)
    npt.assert_allclose(Pfs2, Pfs, rtol=1e-8, atol=1e-11)
    npt.assert_allclose(nll2, nll, rtol=1e-8)
    mss2, Pss2 = rts_parallel_tv(Fs, cs, Sig, mfs2, Pfs2)
    npt.assert_allclose(mss2, mss, rtol=1e-7, atol=1e-10)
    npt.assert_allclose(Pss2, Pss, rtol=1e-7, atol=1e-10)


def test_tv_blocked_equals_flat():
    """Blocked scan == flat associative scan on the time-varying path
    (non-divisible T=150 with block_size=32: nb=5, 10 padded
    identities)."""
    F, Sigma, H, m0, P0, ys = _lgssm()
    Fs = jnp.broadcast_to(F, (T, 2, 2))
    cs = jnp.zeros((T, 2))
    Sig = jnp.broadcast_to(Sigma, (T, 2, 2))
    flat = kf_parallel_tv(Fs, cs, Sig, H, XI, m0, P0, ys)
    blk = kf_parallel_tv(Fs, cs, Sig, H, XI, m0, P0, ys, block_size=32)
    for a, b in zip(flat, blk):
        npt.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    flat_s = rts_parallel_tv(Fs, cs, Sig, flat[0], flat[1])
    blk_s = rts_parallel_tv(Fs, cs, Sig, flat[0], flat[1], block_size=32)
    for a, b in zip(flat_s, blk_s):
        npt.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    out_f = psgp_filter_smoother(disc_m32(ELL, SIGMA), gauss_hermite(2, 3),
                                 H, XI, m0, P0, DT, ys, num_iters=2)
    out_b = psgp_filter_smoother(disc_m32(ELL, SIGMA), gauss_hermite(2, 3),
                                 H, XI, m0, P0, DT, ys, num_iters=2,
                                 block_size=32)
    for a, b in zip(out_f, out_b):
        npt.assert_allclose(a, b, rtol=1e-8, atol=1e-11)


def test_slr_exact_on_linear():
    """SLR of a linear transition recovers (F, 0, Sigma) for any
    nominal."""
    trans = disc_m32(ELL, SIGMA)
    F, Sigma = m32_solution(ELL, SIGMA, DT)
    rule = cubature(2)
    ms = jax.random.normal(jax.random.PRNGKey(0), (5, 2))
    Ps = jnp.broadcast_to(stationary_cov_m32(ELL, SIGMA), (5, 2, 2))
    Fs, cs, Lams = slr_transitions(trans, rule, DT, ms, Ps)
    for k in range(5):
        npt.assert_allclose(Fs[k], F, rtol=1e-8, atol=1e-10)
        npt.assert_allclose(cs[k], jnp.zeros(2), atol=1e-9)
        npt.assert_allclose(Lams[k], Sigma, rtol=1e-7, atol=1e-10)


def test_psgp_equals_kf_on_lti():
    F, Sigma, H, m0, P0, ys = _lgssm()
    mfs, Pfs, nll = kf(F, Sigma, H, XI, m0, P0, ys)
    mss, Pss = rts(F, Sigma, mfs, Pfs)
    out = psgp_filter_smoother(disc_m32(ELL, SIGMA), gauss_hermite(2, 3),
                               H, XI, m0, P0, DT, ys, num_iters=2)
    mfs2, Pfs2, nll2, mss2, Pss2 = out
    npt.assert_allclose(mfs2, mfs, rtol=1e-6, atol=1e-9)
    npt.assert_allclose(nll2, nll, rtol=1e-6)
    npt.assert_allclose(mss2, mss, rtol=1e-6, atol=1e-9)
    npt.assert_allclose(Pss2, Pss, rtol=1e-6, atol=1e-9)


@pytest.mark.slow
def test_psgp_chirp_accuracy_vs_sequential():
    """On the canonical chirp config the iterated parallel smoother's IF
    estimate matches or beats the sequential SGP smoother."""
    dt, T_, Xi = 1e-3, 1000, 0.1
    ts = jnp.linspace(dt, dt * T_, T_)
    freq_func, phase_func = meow_freq(offset=8.0)
    key = jax.random.PRNGKey(555)
    ys = gen_chirp(ts, constant_mag(1.0), phase_func) \
        + math.sqrt(Xi) * jax.random.normal(key, (T_,))

    params = g(g_inv(jnp.array([0.1, 0.1, 0.1, 1.0, 1.0, 7.0])))
    pack = build_chirp_model(params)
    rule = gauss_hermite(4, order=3)

    mfs, Pfs, nll_seq = sgp_filter(pack.m_and_cov, rule, pack.H, Xi,
                                   pack.m0, pack.P0, dt, ys)
    mss_seq, _ = sgp_smoother(pack.m_and_cov, rule, mfs, Pfs, dt)

    out = psgp_filter_smoother(pack.m_and_cov, rule, pack.H, Xi,
                               pack.m0, pack.P0, dt, ys, num_iters=10)
    _, _, nll_par, mss_par, _ = out

    true_if = freq_func(ts)
    err_seq = float(rmse(true_if, g(mss_seq[:, 2])))
    err_par = float(rmse(true_if, g(mss_par[:, 2])))
    assert np.isfinite(err_par)
    # Iterated posterior linearization should be competitive.
    assert err_par < 1.5 * err_seq + 0.2, (err_par, err_seq)
    # Smoothed V-means should agree closely between the two algorithms.
    npt.assert_allclose(np.asarray(mss_par[:, 2]),
                        np.asarray(mss_seq[:, 2]), atol=0.3)


@pytest.mark.slow
def test_psgp_warm_start_nominal():
    """A data-informed warm-start nominal (one sequential pass) lets a
    SINGLE psgp iteration land near the sequential smoother -- the
    standard fix for first-iteration divergence from a prior nominal on
    strongly nonlinear configs (ROADMAP R8)."""
    dt, T_, Xi = 1e-3, 600, 0.1
    ts = jnp.linspace(dt, dt * T_, T_)
    freq_func, phase_func = meow_freq(offset=8.0)
    ys = gen_chirp(ts, constant_mag(1.0), phase_func) \
        + math.sqrt(Xi) * jax.random.normal(jax.random.PRNGKey(7), (T_,))

    params = g(g_inv(jnp.array([0.1, 0.1, 0.1, 1.0, 1.0, 7.0])))
    pack = build_chirp_model(params)
    rule = gauss_hermite(4, order=3)

    mfs, Pfs, _ = sgp_filter(pack.m_and_cov, rule, pack.H, Xi,
                             pack.m0, pack.P0, dt, ys)
    mss_seq, Pss_seq = sgp_smoother(pack.m_and_cov, rule, mfs, Pfs, dt)

    nominal = (jnp.concatenate([pack.m0[None], mss_seq[:-1]]),
               jnp.concatenate([pack.P0[None], Pss_seq[:-1]]))
    out = psgp_filter_smoother(pack.m_and_cov, rule, pack.H, Xi,
                               pack.m0, pack.P0, dt, ys, num_iters=1,
                               init_nominal=nominal)
    _, _, _, mss_warm, _ = out
    # One warm-started iteration stays close to the sequential smoother
    # (posterior linearization about the sequential posterior).
    npt.assert_allclose(np.asarray(mss_warm[:, 2]),
                        np.asarray(mss_seq[:, 2]), atol=0.15)
