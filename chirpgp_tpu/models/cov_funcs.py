"""Covariance functions of the chirp SDEs: closed forms for the harmonic
SDE and Monte-Carlo estimation for the chirp SDE (reference
``chirpgp/cov_funcs.py``; paper Figs 1-3).
"""

import math
from functools import partial
from typing import Callable, Tuple, Union

import jax
import jax.numpy as jnp

from chirpgp_tpu.models.chirp import (
    model_chirp, disc_chirp_lcd, disc_chirp_lcd_cond_v)
from chirpgp_tpu.models.matern import disc_m32
from chirpgp_tpu.utils.numerics import ou_variance
from chirpgp_tpu.utils.sim import simulate_sde, simulate_function_parametrised_sde

__all__ = [
    "transition_harmonic_sde", "marginal_cov_harmonic_sde", "cov_harmonic_sde",
    "vmap_marginal_cov_harmonic_sde", "vmap_cov_harmonic_sde",
    "approx_cov_chirp_sde", "approx_cond_cov_chirp_sde", "psd_chirp_sde",
]


def transition_harmonic_sde(t, s, lam, w) -> jnp.ndarray:
    """Transition semigroup of the damped harmonic SDE over ``t - s``
    (reference ``chirpgp/cov_funcs.py:30-55``)."""
    dt = t - s
    c, sn = jnp.cos(dt * w), jnp.sin(dt * w)
    return jnp.stack([jnp.stack([c, -sn]), jnp.stack([sn, c])]) * jnp.exp(-lam * dt)


def marginal_cov_harmonic_sde(t, s, cov_xs, lam, b, w) -> jnp.ndarray:
    """Marginal covariance ``F cov_xs F^T + Sigma(t - s)`` of the harmonic
    SDE (reference ``chirpgp/cov_funcs.py:58-90``), with the ``lam == 0``
    branch handled smoothly via ``phi1``."""
    F = transition_harmonic_sde(t, s, lam, w)
    return F @ cov_xs @ F.T + ou_variance(b, lam, t - s) * jnp.eye(2)


def cov_harmonic_sde(t1, t2, cov_xs, f, lam, b) -> jnp.ndarray:
    """Two-sided covariance function ``Cov[X(t1), X(t2)]`` (reference
    ``chirpgp/cov_funcs.py:93-131``)."""
    w = 2.0 * math.pi * f

    def when_t1_lt_t2(_):
        return marginal_cov_harmonic_sde(t1, 0.0, cov_xs, lam, b, w) \
            @ transition_harmonic_sde(t2, t1, lam, w).T

    def otherwise(_):
        return transition_harmonic_sde(t1, t2, lam, w) \
            @ marginal_cov_harmonic_sde(t2, 0.0, cov_xs, lam, b, w)

    return jax.lax.cond(t1 < t2, when_t1_lt_t2, otherwise, 0.0)


vmap_marginal_cov_harmonic_sde = jax.vmap(
    marginal_cov_harmonic_sde, in_axes=[0, None, None, None, None, None])
vmap_cov_harmonic_sde = jax.vmap(
    jax.vmap(cov_harmonic_sde, in_axes=[0, None, None, None, None, None]),
    in_axes=[None, 0, None, None, None, None])


def _monte_carlo_cov_of_sde(gen_trajectory: Callable, T: int,
                            key: jnp.ndarray, num_mcs: int) -> jnp.ndarray:
    """Full (T, T, d, d) covariance surface from MC trajectories
    (reference ``chirpgp/cov_funcs.py:141-160``).

    One einsum over all time pairs instead of the reference's double-vmapped
    per-pair outer-product sums -- O(T^2 d^2 N) in a single batched
    contraction.
    """
    keys = jax.random.split(key, num_mcs)
    trajs = gen_trajectory(keys)                     # (N, T, d)
    devs = trajs - jnp.mean(trajs, axis=0)           # (N, T, d)
    # Note: the reference normalizes by (T - 1); we keep that contract.
    return jnp.einsum("nki,nlj->lkij", devs, devs) / (T - 1)


def approx_cov_chirp_sde(ts, lam, b, ell, sigma, delta, num_mcs, key):
    """MC estimate of the chirp-SDE covariance function (reference
    ``chirpgp/cov_funcs.py:163-185``)."""
    _, _, m0, P0, _ = model_chirp(lam, b, ell, sigma, delta)
    m_and_cov = disc_chirp_lcd(lam, b, ell, sigma)
    dt = ts[1] - ts[0]
    T = ts.shape[0]

    @partial(jax.vmap, in_axes=[0])
    def gen_trajectory(k):
        return simulate_sde(m_and_cov, m0, P0, dt, T, k, const_diag_cov=False)

    return _monte_carlo_cov_of_sde(gen_trajectory, T, key, num_mcs)


def approx_cond_cov_chirp_sde(ts, lam, b, ell, sigma, delta, num_mcs,
                              key) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Simulate one V path, then MC covariance of X | V (reference
    ``chirpgp/cov_funcs.py:188-210``)."""
    _, _, m0, P0, _ = model_chirp(lam, b, ell, sigma, delta)
    m_and_cov_of_v = disc_m32(ell, sigma)
    dt = ts[1] - ts[0]
    T = ts.shape[0]

    vs = simulate_sde(m_and_cov_of_v, m0[2:], P0[2:, 2:], dt, T, key,
                      const_diag_cov=False)
    m_and_cov_of_x = disc_chirp_lcd_cond_v(lam, b)

    @partial(jax.vmap, in_axes=[0])
    def gen_trajectory(k):
        return simulate_function_parametrised_sde(
            m_and_cov_of_x, vs[:, 0], m0[:2], P0[:2, :2], dt, T, k,
            const_diag_cov=True)

    key, _ = jax.random.split(key)
    return vs, _monte_carlo_cov_of_sde(gen_trajectory, T, key, num_mcs)


def psd_chirp_sde(ts, lam, b, ell, sigma, delta, num_mcs, key
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """MC power-spectral-density estimate of the chirp-SDE signal
    component X1.

    The reference left this unimplemented (``chirpgp/cov_funcs.py:213-215``
    is a TODO stub); here it is a Hann-windowed averaged periodogram
    (Welch with one segment per MC realization): simulate ``num_mcs``
    trajectories, window, batched real FFT on device, average
    ``|X(f)|^2``.  Returns ``(freqs (T//2+1,), psd (T//2+1,))`` with the
    one-sided density convention (interior bins doubled), in units of
    power per Hz.
    """
    _, _, m0, P0, _ = model_chirp(lam, b, ell, sigma, delta)
    m_and_cov = disc_chirp_lcd(lam, b, ell, sigma)
    dt = ts[1] - ts[0]
    T = ts.shape[0]

    keys = jax.random.split(key, num_mcs)
    trajs = jax.vmap(
        lambda k: simulate_sde(m_and_cov, m0, P0, dt, T, k,
                               const_diag_cov=False))(keys)    # (N, T, d)
    xs = trajs[:, :, 0]
    window = 0.5 * (1.0 - jnp.cos(
        2.0 * jnp.pi * jnp.arange(T, dtype=xs.dtype) / T))     # Hann
    spec = jnp.fft.rfft(xs * window[None, :], axis=-1)         # (N, T//2+1)
    scale = dt / jnp.sum(window ** 2)
    psd = scale * jnp.mean(jnp.abs(spec) ** 2, axis=0)
    n_bins = psd.shape[0]
    doubling = jnp.where(
        (jnp.arange(n_bins) > 0) & (jnp.arange(n_bins) < n_bins - 1 + (T % 2)),
        2.0, 1.0).astype(psd.dtype)
    freqs = jnp.fft.rfftfreq(T, d=dt).astype(psd.dtype)
    return freqs, psd * doubling
