"""Sequential Gaussian filters (discrete-time and continuous-discrete).

All filters are ``lax.scan`` recursions over the measurement sequence that
accumulate the negative filter-marginal log-likelihood in the carry, and all
return ``(mfs, Pfs, nll_cumulative)`` exactly like the reference
(``chirpgp/filters_smoothers.py:145-582``).  Every filter vmaps cleanly over
a leading Monte-Carlo axis; see ``chirpgp_tpu.parallel`` for sharded sweeps
and ``chirpgp_tpu.infer.parallel_kf`` for the associative-scan
(parallel-in-time) formulations.
"""

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from chirpgp_tpu.infer.common import (
    linear_predict, linear_update, log_normal_pdf, sgp_prediction,
    cd_sgp_moment_odes)
from chirpgp_tpu.models.transitions import Transition, as_transition
from chirpgp_tpu.quad.integrators import rk4_m_cov
from chirpgp_tpu.quad.sigma_points import SigmaPoints

__all__ = ["kf", "ekf", "ekf_for_kpt", "sgp_filter", "cd_ekf", "cd_sgp_filter"]

FilterResult = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]


def _run_filter(predict, m0, P0, H, Xi, ys,
                remat: bool = False, unroll: int = 1) -> FilterResult:
    """Common scan skeleton: predict -> 1-D linear update -> accumulate NLL.

    ``remat=True`` checkpoints each scan step for reverse-mode AD:
    only the (d + d^2)-word carry is saved per step and the prediction
    internals (e.g. the four RK4 stages x S sigma-point propagations of
    the CD filters) are recomputed on the backward pass -- required to
    fit batched gradients through T~3k scans in device memory.

    ``unroll`` forwards to ``lax.scan``: the per-step bodies are tiny
    (d<=12 algebra), so executing several steps per loop iteration
    amortizes the scan's per-iteration overhead at zero numerical cost
    (same ops in the same order -- bit-identical output)."""

    def step(carry, y):
        mf, Pf, n_ell = carry
        mp, Pp = predict(mf, Pf)
        mf, Pf, inc = linear_update(mp, Pp, H, Xi, y)
        n_ell = n_ell + inc
        out = (mf, Pf, n_ell)
        return out, out

    if remat:
        step = jax.checkpoint(step)
    init = (m0, P0, jnp.zeros((), dtype=m0.dtype))
    _, (mfs, Pfs, n_ell) = jax.lax.scan(step, init, ys, unroll=unroll)
    return mfs, Pfs, n_ell


def kf(F: jnp.ndarray, Sigma: jnp.ndarray, H: jnp.ndarray, Xi,
       m0: jnp.ndarray, P0: jnp.ndarray, ys: jnp.ndarray) -> FilterResult:
    """Kalman filter for LGSSMs with 1-D measurements (reference
    ``filters_smoothers.py:145-184``)."""
    return _run_filter(lambda m, P: linear_predict(F, Sigma, m, P),
                       m0, P0, H, Xi, ys)


def ekf(cond_m_cov, H: jnp.ndarray, Xi, m0: jnp.ndarray, P0: jnp.ndarray,
        dt, ys: jnp.ndarray) -> FilterResult:
    """Extended Kalman filter: discretize-then-linearize via
    ``jacfwd`` of the conditional mean (reference
    ``filters_smoothers.py:222-264``)."""
    trans = as_transition(cond_m_cov)

    def predict(mf, Pf):
        mean_fn = lambda u: trans.mean(u, dt)
        F = jax.jacfwd(mean_fn)(mf)
        mp = mean_fn(mf)
        Sigma = trans.cov_const(dt) if trans.const_cov else trans.cov(mf, dt)
        return mp, F @ Pf @ F.T + Sigma

    return _run_filter(predict, m0, P0, H, Xi, ys)


def ekf_for_kpt(F: jnp.ndarray, Sigma: jnp.ndarray, h: Callable, Xi,
                m0: jnp.ndarray, P0: jnp.ndarray, dt, ys: jnp.ndarray) -> FilterResult:
    """EKF with linear dynamics and a nonlinear scalar measurement ``h``
    (for the KPT model; reference ``filters_smoothers.py:267-314``)."""

    def step(carry, y):
        mf, Pf, n_ell = carry
        mp, Pp = linear_predict(F, Sigma, mf, Pf)
        H = jax.jacfwd(h)(mp)
        S = H @ Pp @ H + Xi
        K = Pp @ H / S
        pred = h(mp)
        mf = mp + K * (y - pred)
        Pf = Pp - jnp.outer(K, K) * S
        n_ell = n_ell - log_normal_pdf(y, pred, S)
        out = (mf, Pf, n_ell)
        return out, out

    init = (m0, P0, jnp.zeros((), dtype=m0.dtype))
    _, (mfs, Pfs, n_ell) = jax.lax.scan(step, init, ys)
    return mfs, Pfs, n_ell


def sgp_filter(cond_m_cov, sgps: SigmaPoints, H: jnp.ndarray, Xi,
               m0: jnp.ndarray, P0: jnp.ndarray, dt,
               ys: jnp.ndarray) -> FilterResult:
    """Sigma-point Gaussian filter through a discretized SDE (reference
    ``filters_smoothers.py:446-490``)."""
    trans = as_transition(cond_m_cov)

    def predict(mf, Pf):
        mp, Pp, _, _ = sgp_prediction(sgps, trans, dt, mf, Pf)
        return mp, Pp

    return _run_filter(predict, m0, P0, H, Xi, ys)


def cd_ekf(a: Callable, b: Callable, H: jnp.ndarray, Xi,
           m0: jnp.ndarray, P0: jnp.ndarray, dt, ys: jnp.ndarray,
           remat: bool = False, unroll: int = 1) -> FilterResult:
    """Continuous-discrete EKF: RK4 on the linearized moment ODEs
    ``m' = a(m)``, ``P' = P J^T + J P + BB^T`` (reference
    ``filters_smoothers.py:352-397``)."""
    jac_of_a = jax.jacfwd(a)

    def odes(m, P):
        J = jac_of_a(m)
        return a(m), P @ J.T + J @ P + b(m) @ b(m).T

    return _run_filter(lambda m, P: rk4_m_cov(odes, m, P, dt),
                       m0, P0, H, Xi, ys, remat=remat, unroll=unroll)


def cd_sgp_filter(a: Callable, b: jnp.ndarray, sgps: SigmaPoints,
                  H: jnp.ndarray, Xi, m0: jnp.ndarray, P0: jnp.ndarray,
                  dt, ys: jnp.ndarray, remat: bool = False,
                  unroll: int = 1) -> FilterResult:
    """Continuous-discrete sigma-point filter: RK4 on the sigma-point moment
    ODEs with constant dispersion matrix ``b`` (reference
    ``filters_smoothers.py:534-582``)."""
    vec_drift = jax.vmap(a)

    def odes(m, P):
        return cd_sgp_moment_odes(sgps, vec_drift, b, m, P)

    return _run_filter(lambda m, P: rk4_m_cov(odes, m, P, dt),
                       m0, P0, H, Xi, ys, remat=remat, unroll=unroll)
