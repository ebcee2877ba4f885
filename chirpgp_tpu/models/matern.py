"""Matern-3/2 SDE: closed-form transition and stationary covariance.

The IF prior ``V`` is the first component of a Matern-3/2 process written as
the 2-D SDE ``d(V, dV) = [[0, 1], [-gamma^2, -2 gamma]] (V, dV) dt +
(0, 2 sigma gamma^{3/2}) dW`` with ``gamma = sqrt(3)/ell``.

Closed forms match the reference's symbolic solution
(``chirpgp/models.py:56-73``); they are the accuracy backbone of the LCD
discretizations.
"""

import math
from typing import Tuple

import jax.numpy as jnp

from chirpgp_tpu.models.transitions import Transition

__all__ = ["stationary_cov_m32", "m32_solution", "m32_transition_mean",
           "disc_m32"]


def stationary_cov_m32(ell, sigma) -> jnp.ndarray:
    """Stationary covariance diag(sigma^2, gamma^2 sigma^2) of the
    Matern-3/2 state (reference ``chirpgp/models.py:56-58``)."""
    gamma_sq = 3.0 / ell ** 2
    return jnp.array([[1.0, 0.0], [0.0, 0.0]]) * sigma ** 2 + \
        jnp.array([[0.0, 0.0], [0.0, 1.0]]) * (gamma_sq * sigma ** 2)


def _sigma11_factor(eta):
    r"""``f(eta) = 1 - e^{-2 eta} (1 + 2 eta + 2 eta^2)``, the position-noise
    variance factor of the Matern-3/2 transition.

    The direct expression cancels catastrophically in float32: ``f`` is
    O(eta^3) while both operands are O(1), so for the canonical dt=1e-3
    (eta ~ 1.7e-3, f ~ 7e-9) float32 loses *all* significant bits (observed
    error >100x in float32).  Switch to the Taylor series
    ``4/3 eta^3 - 2 eta^4 + 8/5 eta^5 - 8/9 eta^6`` for small eta, whose
    relative truncation error at the 0.15 crossover is ~2e-3 while the
    direct form's float32 rounding error there is comparable and shrinking.
    """
    small = eta < 0.15
    eta_safe = jnp.where(small, 1.0, eta)
    direct = 1.0 - jnp.exp(-2.0 * eta_safe) \
        * (1.0 + 2.0 * eta_safe + 2.0 * eta_safe ** 2)
    e2, e3 = eta * eta, eta * eta * eta
    taylor = e3 * (4.0 / 3.0 - 2.0 * eta + (8.0 / 5.0) * e2
                   - (8.0 / 9.0) * e3)
    return jnp.where(small, taylor, direct)


def m32_solution(ell, sigma, dt) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact discrete transition matrix and noise covariance of the
    Matern-3/2 SDE over ``dt`` (reference ``chirpgp/models.py:61-73``),
    in a float32-safe formulation (see :func:`_sigma11_factor`)."""
    gamma = math.sqrt(3.0) / ell if not hasattr(ell, "dtype") else jnp.sqrt(3.0) / ell
    eta = dt * gamma
    decay = jnp.exp(-eta)
    beta = sigma ** 2 * jnp.exp(-2.0 * eta)

    F = jnp.stack([
        jnp.stack([(1.0 + eta) * decay, dt * decay]),
        jnp.stack([-dt * gamma ** 2 * decay, (1.0 - eta) * decay]),
    ])
    off = 2.0 * dt ** 2 * gamma ** 3 * beta
    s11 = sigma ** 2 * _sigma11_factor(eta)
    s22 = gamma ** 2 * (sigma ** 2 + beta * (2.0 * eta - 2.0 * eta ** 2 - 1.0))
    Sigma = jnp.stack([
        jnp.stack([s11, off]),
        jnp.stack([off, s22]),
    ])
    return F, Sigma


def m32_transition_mean(u: jnp.ndarray, F: jnp.ndarray) -> jnp.ndarray:
    """Apply the 2x2 Matern transition to states ``u`` of shape (..., 2)."""
    return jnp.einsum("ij,...j->...i", F, u)


def disc_m32(ell, sigma) -> Transition:
    """Exact discretization of the Matern-3/2 SDE as a :class:`Transition`
    (reference ``chirpgp/models.py:408-416``)."""

    def mean(u, dt):
        F, _ = m32_solution(ell, sigma, dt)
        return m32_transition_mean(u, F)

    def cov(_, dt):
        return m32_solution(ell, sigma, dt)[1]

    def mean_cf(u, dt):
        F, _ = m32_solution(ell, sigma, dt)
        return jnp.einsum("ij,...jb->...ib", F, u)

    return Transition(mean=mean, cov=cov, const_cov=True, mean_cf=mean_cf)
