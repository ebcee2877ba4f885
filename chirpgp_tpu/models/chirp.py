"""Chirp / harmonic-chirp / La Scala SDE priors and their locally
conditional discretizations (LCD), in batched accelerator-first form.

Model (reference Eq. 14; ``chirpgp/models.py:76-178``): a harmonic pair
``(X1, X2)`` rotating at angular rate ``2 pi g(V)`` with damping ``lam`` and
dispersion ``b``, coupled to a Matern-3/2 prior on the latent frequency
state ``(V, dV)``.  The measurement reads the second chirp component.

Differences from the reference:

- all conditional means are written as batched elementwise rotations (no
  ``block_diag`` matrix construction per sigma point),
- process covariances are state-independent for this family, exposed via
  ``Transition.const_cov`` so filters skip the per-point covariance reduce,
- the ``lam == 0`` branch (reference ``chirpgp/models.py:302-308``,
  ``lax.cond``) is replaced by the smooth ``phi1`` form, differentiable in
  ``lam`` at 0.
"""

import math
from typing import Callable, NamedTuple, Tuple

import jax.numpy as jnp
import jax.scipy.linalg
import numpy as np

from chirpgp_tpu.models.bijections import g
from chirpgp_tpu.models.matern import (
    stationary_cov_m32, m32_solution, m32_transition_mean)
from chirpgp_tpu.models.transitions import Transition
from chirpgp_tpu.utils.numerics import ou_variance

__all__ = [
    "StateSpaceModel",
    "model_chirp", "model_harmonic_chirp", "model_lascala",
    "disc_chirp_lcd", "disc_chirp_lcd_cond_v", "disc_harmonic_chirp_lcd",
    "disc_model_lascala_lcd",
    "build_chirp_model", "build_harmonic_chirp_model", "build_lascala_model",
]

_TWO_PI = 2.0 * math.pi


class StateSpaceModel(NamedTuple):
    """Continuous-time prior: drift ``a``, dispersion ``B``, initial moments,
    and 1-D linear measurement vector ``H``.  Iterable for reference-style
    unpacking ``drift, dispersion, m0, P0, H = model``."""
    drift: Callable
    dispersion: Callable
    m0: jnp.ndarray
    P0: jnp.ndarray
    H: jnp.ndarray


def _rotate_pair(x0, x1, c, s):
    """Apply the 2-D rotation-with-decay [[c, -s], [s, c]] elementwise."""
    return c * x0 - s * x1, s * x0 + c * x1


# ---------------------------------------------------------------------------
# Continuous-time priors
# ---------------------------------------------------------------------------

def model_chirp(lam, b, ell, sigma, delta) -> StateSpaceModel:
    """The chirp + IF prior, d=4 (reference ``chirpgp/models.py:76-119``).

    State ``(X1, X2, V, dV)``: harmonic pair with damping ``lam`` and
    frequency ``2 pi g(V)``; Matern-3/2 pair on ``(V, dV)``.
    """
    gamma = math.sqrt(3.0) / ell

    def drift(u):
        w = _TWO_PI * g(u[..., 2])
        a0 = -lam * u[..., 0] - w * u[..., 1]
        a1 = w * u[..., 0] - lam * u[..., 1]
        a2 = u[..., 3]
        a3 = -(gamma ** 2) * u[..., 2] - 2.0 * gamma * u[..., 3]
        return jnp.stack([a0, a1, a2, a3], axis=-1)

    def dispersion(_):
        return jnp.diag(jnp.array([b, b, 0.0, 2.0 * sigma * gamma ** 1.5]))

    m0 = jnp.array([0.0, 1.0, 0.0, 0.0])
    P0 = jax.scipy.linalg.block_diag(
        delta * jnp.eye(2), stationary_cov_m32(ell, sigma))
    H = np.array([0.0, 1.0, 0.0, 0.0])   # structural: concrete under jit
    return StateSpaceModel(drift, dispersion, m0, P0, H)


def model_harmonic_chirp(lam, b, ell, sigma, delta, num_harmonics: int = 1,
                         freq_scale: float = 1.0) -> StateSpaceModel:
    """Harmonic chirp prior, d = 2K + 2 (reference
    ``chirpgp/models.py:122-178``).  K harmonic pairs at rates ``k w`` with
    shared ``lam``/``b``/``delta``; frequency ``= freq_scale * g(V)``."""
    K = num_harmonics
    gamma = math.sqrt(3.0) / ell
    ks = jnp.arange(1, K + 1, dtype=jnp.result_type(float))

    def drift(u):
        w = _TWO_PI * g(u[..., -2]) * freq_scale          # (...,)
        pairs = u[..., : 2 * K].reshape(u.shape[:-1] + (K, 2))
        wk = w[..., None] * ks                             # (..., K)
        a_even = -lam * pairs[..., 0] - wk * pairs[..., 1]
        a_odd = wk * pairs[..., 0] - lam * pairs[..., 1]
        a_pairs = jnp.stack([a_even, a_odd], axis=-1).reshape(
            u.shape[:-1] + (2 * K,))
        a_v = u[..., -1]
        a_dv = -(gamma ** 2) * u[..., -2] - 2.0 * gamma * u[..., -1]
        return jnp.concatenate(
            [a_pairs, jnp.stack([a_v, a_dv], axis=-1)], axis=-1)

    def dispersion(_):
        return jnp.diag(jnp.array([b, b] * K + [0.0, 2.0 * sigma * gamma ** 1.5]))

    m0 = jnp.array([0.0, 1.0] * K + [0.0, 0.0])
    P0 = jax.scipy.linalg.block_diag(
        delta * jnp.eye(2 * K), stationary_cov_m32(ell, sigma))
    H = np.array([0.0, 1.0] * K + [0.0, 0.0])   # structural: concrete under jit
    return StateSpaceModel(drift, dispersion, m0, P0, H)


def model_lascala(ell, sigma, delta) -> StateSpaceModel:
    """Snyder / La Scala baseline prior: undamped, dispersion-free chirp
    block (reference ``chirpgp/models.py:181-261``)."""
    gamma = math.sqrt(3.0) / ell

    def drift(u):
        w = _TWO_PI * g(u[..., 2])
        a0 = -w * u[..., 1]
        a1 = w * u[..., 0]
        a2 = u[..., 3]
        a3 = -(gamma ** 2) * u[..., 2] - 2.0 * gamma * u[..., 3]
        return jnp.stack([a0, a1, a2, a3], axis=-1)

    def dispersion(_):
        return jnp.diag(jnp.array([0.0, 0.0, 0.0, 2.0 * sigma * gamma ** 1.5]))

    m0 = jnp.array([0.0, 1.0, 0.0, 0.0])
    P0 = jax.scipy.linalg.block_diag(
        delta * jnp.eye(2), stationary_cov_m32(ell, sigma))
    H = np.array([0.0, 1.0, 0.0, 0.0])   # structural: concrete under jit
    return StateSpaceModel(drift, dispersion, m0, P0, H)


# ---------------------------------------------------------------------------
# Locally conditional discretizations (closed form)
# ---------------------------------------------------------------------------

def disc_chirp_lcd(lam, b, ell, sigma) -> Transition:
    """LCD of the chirp model: rotation-with-decay on the harmonic pair
    (frequency frozen at the conditioning state's ``g(V)``) + exact
    Matern-3/2 step (reference ``chirpgp/models.py:264-311``).

    The covariance is state-independent: ``blockdiag(q, q, Sigma_m32)`` with
    ``q = b^2 (1 - e^{-2 lam dt}) / (2 lam)`` evaluated smoothly in ``lam``.
    """

    def mean(u, dt):
        w = _TWO_PI * g(u[..., 2])
        decay = jnp.exp(-lam * dt)
        c, s = jnp.cos(dt * w) * decay, jnp.sin(dt * w) * decay
        m0_, m1_ = _rotate_pair(u[..., 0], u[..., 1], c, s)
        F32, _ = m32_solution(ell, sigma, dt)
        m_v = m32_transition_mean(u[..., 2:], F32)
        return jnp.concatenate(
            [jnp.stack([m0_, m1_], axis=-1), m_v], axis=-1)

    def cov(_, dt):
        q = ou_variance(b, lam, dt)
        _, S32 = m32_solution(ell, sigma, dt)
        return jax.scipy.linalg.block_diag(q * jnp.eye(2), S32)

    def mean_cf(u, dt):
        # Channels-first: u (..., 4, B); same closed form, component axis
        # second-to-last so the batch stays the minor axis.
        w = _TWO_PI * g(u[..., 2, :])
        decay = jnp.exp(-lam * dt)
        c, sn = jnp.cos(dt * w) * decay, jnp.sin(dt * w) * decay
        F32, _ = m32_solution(ell, sigma, dt)
        m0_ = c * u[..., 0, :] - sn * u[..., 1, :]
        m1_ = sn * u[..., 0, :] + c * u[..., 1, :]
        m2_ = F32[0, 0] * u[..., 2, :] + F32[0, 1] * u[..., 3, :]
        m3_ = F32[1, 0] * u[..., 2, :] + F32[1, 1] * u[..., 3, :]
        return jnp.stack([m0_, m1_, m2_, m3_], axis=-2)

    return Transition(mean=mean, cov=cov, const_cov=True, mean_cf=mean_cf)


def disc_chirp_lcd_cond_v(lam, b):
    """LCD of the chirp pair conditioned on an exogenous ``V`` value:
    ``m_and_cov(u, v, dt)`` (reference ``chirpgp/models.py:314-329``)."""

    def m_and_cov(u, v, dt):
        w = _TWO_PI * g(v)
        decay = jnp.exp(-lam * dt)
        c, s = jnp.cos(dt * w) * decay, jnp.sin(dt * w) * decay
        m0_, m1_ = _rotate_pair(u[..., 0], u[..., 1], c, s)
        cond_m = jnp.stack([m0_, m1_], axis=-1)
        Sigma = ou_variance(b, lam, dt) * jnp.eye(2)
        return cond_m, Sigma

    return m_and_cov


def disc_harmonic_chirp_lcd(lam, b, ell, sigma, num_harmonics: int = 1,
                            freq_scale: float = 1.0) -> Transition:
    """LCD of the harmonic chirp model (reference
    ``chirpgp/models.py:332-386``): K rotation blocks at rates ``k w`` +
    exact Matern-3/2 step; state-independent covariance."""
    K = num_harmonics
    ks = jnp.arange(1, K + 1, dtype=jnp.result_type(float))

    def mean(u, dt):
        w = _TWO_PI * g(u[..., -2]) * freq_scale
        decay = jnp.exp(-lam * dt)
        angles = (dt * w)[..., None] * ks                  # (..., K)
        c, s = jnp.cos(angles) * decay, jnp.sin(angles) * decay
        pairs = u[..., : 2 * K].reshape(u.shape[:-1] + (K, 2))
        m_even, m_odd = _rotate_pair(pairs[..., 0], pairs[..., 1], c, s)
        m_pairs = jnp.stack([m_even, m_odd], axis=-1).reshape(
            u.shape[:-1] + (2 * K,))
        F32, _ = m32_solution(ell, sigma, dt)
        m_v = m32_transition_mean(u[..., -2:], F32)
        return jnp.concatenate([m_pairs, m_v], axis=-1)

    def cov(_, dt):
        q = ou_variance(b, lam, dt)
        _, S32 = m32_solution(ell, sigma, dt)
        return jax.scipy.linalg.block_diag(q * jnp.eye(2 * K), S32)

    def mean_cf(u, dt):
        w = _TWO_PI * g(u[..., -2, :]) * freq_scale
        decay = jnp.exp(-lam * dt)
        F32, _ = m32_solution(ell, sigma, dt)
        outs = []
        for k in range(1, K + 1):
            ang = dt * k * w
            c, sn = jnp.cos(ang) * decay, jnp.sin(ang) * decay
            x0 = u[..., 2 * (k - 1), :]
            x1 = u[..., 2 * k - 1, :]
            outs.append(c * x0 - sn * x1)
            outs.append(sn * x0 + c * x1)
        outs.append(F32[0, 0] * u[..., -2, :] + F32[0, 1] * u[..., -1, :])
        outs.append(F32[1, 0] * u[..., -2, :] + F32[1, 1] * u[..., -1, :])
        return jnp.stack(outs, axis=-2)

    return Transition(mean=mean, cov=cov, const_cov=True, mean_cf=mean_cf)


def disc_model_lascala_lcd(ell, sigma) -> Transition:
    """LCD of the La Scala model: pure rotation (no damping, no chirp
    noise) + exact Matern step (reference ``chirpgp/models.py:419-434``)."""

    def mean(u, dt):
        w = _TWO_PI * g(u[..., 2])
        c, s = jnp.cos(dt * w), jnp.sin(dt * w)
        m0_, m1_ = _rotate_pair(u[..., 0], u[..., 1], c, s)
        F32, _ = m32_solution(ell, sigma, dt)
        m_v = m32_transition_mean(u[..., 2:], F32)
        return jnp.concatenate([jnp.stack([m0_, m1_], axis=-1), m_v], axis=-1)

    def cov(_, dt):
        _, S32 = m32_solution(ell, sigma, dt)
        return jax.scipy.linalg.block_diag(jnp.zeros((2, 2)), S32)

    def mean_cf(u, dt):
        w = _TWO_PI * g(u[..., 2, :])
        c, sn = jnp.cos(dt * w), jnp.sin(dt * w)
        F32, _ = m32_solution(ell, sigma, dt)
        m0_ = c * u[..., 0, :] - sn * u[..., 1, :]
        m1_ = sn * u[..., 0, :] + c * u[..., 1, :]
        m2_ = F32[0, 0] * u[..., 2, :] + F32[0, 1] * u[..., 3, :]
        m3_ = F32[1, 0] * u[..., 2, :] + F32[1, 1] * u[..., 3, :]
        return jnp.stack([m0_, m1_, m2_, m3_], axis=-2)

    return Transition(mean=mean, cov=cov, const_cov=True, mean_cf=mean_cf)


def disc_chirp_euler_maruyama():
    """Euler--Maruyama is not recommended for this stiff model; kept for
    API parity (reference ``chirpgp/models.py:389-392``)."""
    return NotImplemented


# ---------------------------------------------------------------------------
# Parameter-pack builders (the hyperparameter-optimization entry points)
# ---------------------------------------------------------------------------

class ChirpModelPack(NamedTuple):
    """Everything a filter/smoother needs; iterable for reference-style
    unpacking ``drift, dispersion, m_and_cov, m0, P0, H = pack``."""
    drift: Callable
    dispersion: Callable
    m_and_cov: Transition
    m0: jnp.ndarray
    P0: jnp.ndarray
    H: jnp.ndarray


def build_chirp_model(params) -> ChirpModelPack:
    """Chirp model from packed params ``[lam, b, delta, ell, sigma, m0_v]``
    (reference ``chirpgp/models.py:437-459``)."""
    lam, b, delta, ell, sigma, m0_v = params
    drift, dispersion, _, P0, H = model_chirp(lam, b, ell, sigma, delta)
    m0 = jnp.stack([0.0 * m0_v, 0.0 * m0_v, m0_v, 0.0 * m0_v])
    m_and_cov = disc_chirp_lcd(lam, b, ell, sigma)
    return ChirpModelPack(drift, dispersion, m_and_cov, m0, P0, H)


def build_harmonic_chirp_model(params, num_harmonics: int = 1,
                               freq_scale: float = 1.0) -> ChirpModelPack:
    """Harmonic chirp model from packed params (reference
    ``chirpgp/models.py:462-494``)."""
    lam, b, delta, ell, sigma, m0_v = params
    drift, dispersion, _, P0, H = model_harmonic_chirp(
        lam, b, ell, sigma, delta,
        num_harmonics=num_harmonics, freq_scale=freq_scale)
    zero = 0.0 * m0_v
    one = zero + 1.0
    m0 = jnp.stack(([zero, one] * num_harmonics) + [m0_v, zero])
    m_and_cov = disc_harmonic_chirp_lcd(
        lam, b, ell, sigma, num_harmonics=num_harmonics, freq_scale=freq_scale)
    return ChirpModelPack(drift, dispersion, m_and_cov, m0, P0, H)


def build_lascala_model(params) -> ChirpModelPack:
    """La Scala model from packed params ``[delta, ell, sigma, m0_v]``
    (reference ``chirpgp/models.py:497-519``)."""
    delta, ell, sigma, m0_v = params
    drift, dispersion, _, P0, H = model_lascala(ell, sigma, delta)
    m0 = jnp.stack([0.0 * m0_v, 0.0 * m0_v, m0_v, 0.0 * m0_v])
    m_and_cov = disc_model_lascala_lcd(ell, sigma)
    return ChirpModelPack(drift, dispersion, m_and_cov, m0, P0, H)
