"""Square-root (Cholesky-factor) filters and smoothers for float32.

The covariance-form RTS update ``Ps = Pf + G (Ps - Pp) G^T`` is subtractive
and loses positive-definiteness in float32 (observed: smoothed variances
going negative on the canonical chirp config).  The reference sidesteps
this with float64 everywhere (``demos/ghfs_mle.py:18``), at several
times float32's cost on an accelerator.  Here every covariance is
carried as a triangular factor and every update is a QR triangularization -- no subtraction of
near-equal PSD matrices anywhere:

- predict:  qr([sqrt(w_i) (mu_i - mp); Lq^T]) -> Up with Up^T Up = Pp
- update:   qr([[sqrt(Xi), 0]; [Up H^T, Up]]) -> [[sqrt(S), (K sqrt(S))^T];
            [0, Uf]]  (one QR gives gain, innovation variance, and factor)
- smooth:   qr([sqrt(w_i)(mu_i - mp), sqrt(w_i)(chi_i - mf); [Lq^T, 0]])
            -> R11 (pred factor), gain G = (R11^{-1} R12)^T, and R22 with
            R22^T R22 = Pf - G Pp G^T (the PSD conditional covariance);
            then Ps = G Ps' G^T + R22^T R22 by one more QR.

(The same triangularization algebra as the square-root statistical linear
regression smoothers of Yaghoobi et al. 2022, arXiv:2207.00426 -- see
PAPERS.md.)  Requires nonnegative sigma-point weights (cubature /
Gauss-Hermite; not the default unscented rule).

All functions mirror the covariance-form contracts in
``chirpgp_tpu.infer.filters``/``smoothers`` but carry Cholesky factors:
returns are ``(mfs, Lfs, nll)`` / ``(mss, Lss)`` with ``L`` lower
triangular (up to column signs).
"""

import math
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from chirpgp_tpu.infer.common import log_normal_pdf
from chirpgp_tpu.models.transitions import Transition, as_transition
from chirpgp_tpu.quad.sigma_points import SigmaPoints
from chirpgp_tpu.utils.numerics import psd_cholesky

__all__ = ["tria", "sqrt_sgp_filter", "sqrt_sgp_smoother", "sqrt_ekf",
           "sqrt_eks", "sqrt_kf"]


def _require_nonneg_weights(sgps: SigmaPoints, where: str):
    """Sqrt forms take sqrt(w): negative weights (default unscented rule)
    would silently produce NaNs.  Weights are trace-time constants, so this
    check is free."""
    import numpy as np
    if np.any(np.asarray(sgps.w) < 0) or (
            sgps.wc is not None and np.any(np.asarray(sgps.wc) < 0)):
        raise ValueError(
            f"{where} requires nonnegative sigma-point weights "
            "(use cubature or gauss_hermite; the default unscented rule "
            "has a negative center weight -- use the covariance form, or "
            "unscented(d, kappa=0)).")


def _tria_householder(M: jnp.ndarray) -> jnp.ndarray:
    """Upper-triangular factor via d explicit Householder reflections.

    For the tall-skinny pre-arrays here (n ~ 5..100, d ~ 4..16) this is
    pure elementwise/matvec jnp -- it fuses under ``vmap`` over seeds into
    large batched contractions, avoiding the LAPACK-style QR custom call
    whose per-step overhead dominates small problems.  Same
    numerical character as QR (orthogonal transforms on deviations; no
    Gram squaring).
    """
    n, d = M.shape[-2], M.shape[-1]
    eps = jnp.asarray(1e-30, M.dtype)
    for j in range(d):
        x = M[..., j:, j]                                   # (..., n-j)
        normx = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
        sign = jnp.where(x[..., :1] >= 0, 1.0, -1.0)
        alpha = -sign * normx                                # (..., 1)
        v = x.at[..., 0].add(-alpha[..., 0])                 # x - alpha e1
        vnorm2 = jnp.sum(v * v, axis=-1, keepdims=True)
        beta = jnp.where(vnorm2 > eps, 2.0 / jnp.where(vnorm2 > eps,
                                                       vnorm2, 1.0), 0.0)
        sub = M[..., j:, j:]                                 # (..., n-j, d-j)
        w = jnp.einsum("...n,...nd->...d", v, sub)           # v^T sub
        sub = sub - beta[..., None] * v[..., :, None] * w[..., None, :]
        M = M.at[..., j:, j:].set(sub)
    return jnp.triu(M[..., :d, :])


def tria(M: jnp.ndarray, method: str = "hh") -> jnp.ndarray:
    """Upper-triangular factor R with ``R^T R = M^T M`` for tall ``M``
    of shape (..., n, d).

    Two backends:

    - ``"hh"`` (default): explicit unrolled Householder reflections in
      pure jnp -- same orthogonal-transform numerics as ``"qr"`` but
      without the linalg custom call, whose per-call overhead dominates
      small problems (f32-stable at full sequence length; the speed
      ratio is not measured on the H100).
    - ``"qr"``: library Householder QR (custom call).  Same robustness;
      keep as a cross-check.
    - ``"chol"``: ``R = chol(M^T M)^T`` with column equilibration -- one
      batched matmul plus a tiny Cholesky, fewer operations than
      Householder QR, but the Gram squares the condition number:
      float32 breaks on the chirp smoother (empirically; the f32 finiteness
      test fails), so use it only in float64 or for well-conditioned
      pre-arrays.
    """
    if method == "qr":
        return jnp.linalg.qr(M, mode="r")
    if method == "hh":
        return _tria_householder(M)
    # Column equilibration: the chirp models mix columns spanning ~6 orders
    # of magnitude (position noise ~dt^3 vs O(1) states); forming the raw
    # Gram in float32 loses the small columns entirely.  Scale columns to
    # unit norm first -- chol(D A D) = D chol(A) for diagonal D, so the
    # factor is recovered exactly.
    c = jnp.sqrt(jnp.sum(M * M, axis=-2, keepdims=True))      # (..., 1, d)
    c = jnp.where(c > 0, c, 1.0)
    Mh = M / c
    gram = jnp.einsum("...nd,...ne->...de", Mh, Mh)
    L = jnp.linalg.cholesky(gram)                              # unit-ish diag
    return jnp.swapaxes(L, -1, -2) * c


def _chol_to_lower(R: jnp.ndarray) -> jnp.ndarray:
    """R upper (R^T R = P) -> lower factor L = R^T (L L^T = P)."""
    return jnp.swapaxes(R, -1, -2)


def _sqrt_predict_sgp(sgps: SigmaPoints, trans: Transition, dt,
                      mf: jnp.ndarray, Lf: jnp.ndarray,
                      tria_method: str = "hh"):
    """Sigma-point prediction in sqrt form.  Returns (mp, Up, chi, evals)
    with Up upper-triangular, Up^T Up = Pp."""
    chi = sgps.gen_sigma_points(mf, Lf)                     # (S, d)
    evals = trans.mean(chi, dt)                             # (S, d)
    sw = jnp.sqrt(sgps.w).astype(evals.dtype)[:, None]
    mp = jnp.einsum("s,sd->d", sgps.w.astype(evals.dtype), evals)
    dev = sw * (evals - mp)                                 # (S, d)
    Lq = psd_cholesky(trans.cov_const(dt)) if trans.const_cov \
        else psd_cholesky(
            jnp.einsum("s,sij->ij", sgps.w, trans.cov(chi, dt)))
    Lq = Lq.astype(evals.dtype)
    Up = tria(jnp.concatenate([dev, Lq.T], axis=0), tria_method)
    return mp, Up, chi, evals


def _sqrt_update_1d(mp: jnp.ndarray, Up: jnp.ndarray, H: jnp.ndarray,
                    sqrt_Xi, y, tria_method: str = "hh"):
    """1-D-measurement square-root update via one QR.

    Pre-array ((1+d) x (1+d)):
        [[sqrt(Xi), 0 ], [Up H^T, Up]] -> R = [[sqrt(S), w^T], [0, Uf]]
    with w = K sqrt(S).
    """
    d = mp.shape[-1]
    UpHT = Up @ H                                            # (d,)
    top = jnp.concatenate([jnp.atleast_1d(sqrt_Xi),
                           jnp.zeros((d,), mp.dtype)])[None, :]
    bottom = jnp.concatenate([UpHT[:, None], Up], axis=1)
    R = tria(jnp.concatenate([top, bottom], axis=0), tria_method)
    sqrt_S = R[0, 0]
    w = R[0, 1:]                                             # K sqrt(S)
    Uf = R[1:, 1:]
    innov = y - H @ mp
    mf = mp + w * (innov / sqrt_S)
    nll_inc = -log_normal_pdf(y, H @ mp, sqrt_S ** 2)
    return mf, Uf, nll_inc


def sqrt_sgp_filter(cond_m_cov, sgps: SigmaPoints, H: jnp.ndarray, Xi,
                    m0: jnp.ndarray, P0: jnp.ndarray, dt,
                    ys: jnp.ndarray,
                    tria_method: str = "hh",
                    remat: bool = True,
                    unroll: int = 1) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Square-root sigma-point filter; float32-safe drop-in for
    :func:`chirpgp_tpu.infer.filters.sgp_filter` returning Cholesky
    factors ``Lfs`` instead of covariances.

    ``remat`` checkpoints each scan step for reverse-mode AD: residual
    memory drops from O(T * sigma-point intermediates) to O(T * carry),
    which kept gradient-through-the-filter MLE at T ~ 3000+ within a
    16 GB device; its cost and need on the H100's 80 GB are not measured
    (ROADMAP S2).
    """
    _require_nonneg_weights(sgps, "sqrt_sgp_filter")
    trans = as_transition(cond_m_cov)
    sqrt_Xi = jnp.sqrt(jnp.asarray(Xi, m0.dtype))
    L0 = jnp.linalg.cholesky(P0)

    def step(carry, y):
        mf, Lf, n_ell = carry
        mp, Up, _, _ = _sqrt_predict_sgp(sgps, trans, dt, mf, Lf,
                                         tria_method)
        mf, Uf, inc = _sqrt_update_1d(mp, Up, H, sqrt_Xi, y, tria_method)
        Lf = _chol_to_lower(Uf)
        n_ell = n_ell + inc
        out = (mf, Lf, n_ell)
        return out, out

    if remat:
        step = jax.checkpoint(step)
    init = (m0, L0, jnp.zeros((), m0.dtype))
    _, (mfs, Lfs, n_ell) = jax.lax.scan(step, init, ys, unroll=unroll)
    return mfs, Lfs, n_ell


def sqrt_sgp_smoother(cond_m_cov, sgps: SigmaPoints, mfs: jnp.ndarray,
                      Lfs: jnp.ndarray, dt,
                      tria_method: str = "hh") -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Square-root sigma-point RTS smoother (no subtractive covariance
    update).  Consumes the sqrt filter's ``(mfs, Lfs)``."""
    _require_nonneg_weights(sgps, "sqrt_sgp_smoother")
    trans = as_transition(cond_m_cov)
    d = mfs.shape[-1]
    sw_fn = jnp.sqrt(sgps.w).astype(mfs.dtype)[:, None]

    def step(carry, elem):
        ms, Ls = carry
        mf, Lf = elem
        chi = sgps.gen_sigma_points(mf, Lf)
        evals = trans.mean(chi, dt)
        mp = jnp.einsum("s,sd->d", sgps.w.astype(evals.dtype), evals)
        dev_pred = sw_fn * (evals - mp)                      # (S, d)
        dev_prev = sw_fn * (chi - mf)                        # (S, d)
        Lq = psd_cholesky(trans.cov_const(dt)) if trans.const_cov \
            else psd_cholesky(
                jnp.einsum("s,sij->ij", sgps.w, trans.cov(chi, dt)))
        Lq = Lq.astype(evals.dtype)
        # Joint triangularization: R^T R = [[Pp, D^T], [D, Pf]].
        M = jnp.concatenate([
            jnp.concatenate([dev_pred, dev_prev], axis=1),
            jnp.concatenate([Lq.T, jnp.zeros((d, d), mfs.dtype)], axis=1),
        ], axis=0)
        R = tria(M, tria_method)                             # (2d, 2d)
        R11, R12, R22 = R[:d, :d], R[:d, d:], R[d:, d:]
        # Gain G = D Pp^{-1} = (R11^{-1} R12)^T via triangular solve.
        G = jax.scipy.linalg.solve_triangular(R11, R12, lower=False).T
        ms = mf + G @ (ms - mp)
        Ls = _chol_to_lower(
            tria(jnp.concatenate([(G @ Ls).T, R22], axis=0), tria_method))
        return (ms, Ls), (ms, Ls)

    init = (mfs[-1], Lfs[-1])
    _, (mss, Lss) = jax.lax.scan(step, init, (mfs[:-1], Lfs[:-1]),
                                 reverse=True)
    return jnp.concatenate([mss, mfs[-1][None]]), \
        jnp.concatenate([Lss, Lfs[-1][None]])


def sqrt_kf(F: jnp.ndarray, Sigma: jnp.ndarray, H: jnp.ndarray, Xi,
            m0: jnp.ndarray, P0: jnp.ndarray, ys: jnp.ndarray):
    """Square-root Kalman filter for LGSSMs: predict by
    ``qr([Lf^T F^T; Lq^T])``, update by the shared 1-D QR update."""
    sqrt_Xi = jnp.sqrt(jnp.asarray(Xi, m0.dtype))
    L0 = jnp.linalg.cholesky(P0)
    Lq = psd_cholesky(Sigma)

    def step(carry, y):
        mf, Lf, n_ell = carry
        mp = F @ mf
        Up = tria(jnp.concatenate([(F @ Lf).T, Lq.T], axis=0))
        mf, Uf, inc = _sqrt_update_1d(mp, Up, H, sqrt_Xi, y)
        out = (mf, _chol_to_lower(Uf), n_ell + inc)
        return out, out

    init = (m0, L0, jnp.zeros((), m0.dtype))
    _, (mfs, Lfs, n_ell) = jax.lax.scan(step, init, ys)
    return mfs, Lfs, n_ell


def sqrt_ekf(cond_m_cov, H: jnp.ndarray, Xi, m0: jnp.ndarray,
             P0: jnp.ndarray, dt, ys: jnp.ndarray, unroll: int = 1):
    """Square-root EKF: linearize the discretized mean map, triangularize
    ``[Lf^T F^T; Lq^T]``."""
    trans = as_transition(cond_m_cov)
    sqrt_Xi = jnp.sqrt(jnp.asarray(Xi, m0.dtype))
    L0 = jnp.linalg.cholesky(P0)
    mean_fn = lambda u: trans.mean(u, dt)

    def step(carry, y):
        mf, Lf, n_ell = carry
        F = jax.jacfwd(mean_fn)(mf)
        mp = mean_fn(mf)
        Sigma = trans.cov_const(dt) if trans.const_cov else trans.cov(mf, dt)
        Lq = psd_cholesky(Sigma).astype(mf.dtype)
        Up = tria(jnp.concatenate([(F @ Lf).T, Lq.T], axis=0))
        mf, Uf, inc = _sqrt_update_1d(mp, Up, H, sqrt_Xi, y)
        out = (mf, _chol_to_lower(Uf), n_ell + inc)
        return out, out

    init = (m0, L0, jnp.zeros((), m0.dtype))
    _, (mfs, Lfs, n_ell) = jax.lax.scan(step, init, ys, unroll=unroll)
    return mfs, Lfs, n_ell


def sqrt_eks(cond_m_cov, mfs: jnp.ndarray, Lfs: jnp.ndarray,
             dt) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Square-root extended Kalman smoother."""
    trans = as_transition(cond_m_cov)
    d = mfs.shape[-1]
    mean_fn = lambda u: trans.mean(u, dt)

    def step(carry, elem):
        ms, Ls = carry
        mf, Lf = elem
        F = jax.jacfwd(mean_fn)(mf)
        mp = mean_fn(mf)
        Sigma = trans.cov_const(dt) if trans.const_cov else trans.cov(mf, dt)
        Lq = psd_cholesky(Sigma).astype(mf.dtype)
        M = jnp.concatenate([
            jnp.concatenate([(F @ Lf).T, Lf.T], axis=1),
            jnp.concatenate([Lq.T, jnp.zeros((d, d), mfs.dtype)], axis=1),
        ], axis=0)
        R = tria(M)
        R11, R12, R22 = R[:d, :d], R[:d, d:], R[d:, d:]
        G = jax.scipy.linalg.solve_triangular(R11, R12, lower=False).T
        ms = mf + G @ (ms - mp)
        Ls = _chol_to_lower(
            tria(jnp.concatenate([(G @ Ls).T, R22], axis=0)))
        return (ms, Ls), (ms, Ls)

    init = (mfs[-1], Lfs[-1])
    _, (mss, Lss) = jax.lax.scan(step, init, (mfs[:-1], Lfs[:-1]),
                                 reverse=True)
    return jnp.concatenate([mss, mfs[-1][None]]), \
        jnp.concatenate([Lss, Lfs[-1][None]])
