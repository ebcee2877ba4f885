"""Parallel-in-time *nonlinear* filtering/smoothing: iterated posterior
statistical linearization over the associative-scan Kalman machinery.

The sequential sigma-point filter is O(T) because each step linearizes
about the previous filtered mean.  Here the whole trajectory is
statistically linearized at once about a nominal posterior (one big
batched sigma-point regression over all T steps), the
resulting time-varying affine-Gaussian SSM is solved with the O(log T)
associative-scan filter/smoother, and the procedure is iterated to the
posterior-linearization fixed point (IPLS: Garcia-Fernandez et al.; the
parallel form of Yaghoobi et al. 2021, arXiv:2102.00514 -- PAPERS.md).

On a linear model one iteration reproduces KF/RTS exactly (statistical
linearization of an affine map is exact regardless of the nominal).  On
nonlinear models the fixed point is the iterated smoother -- generally as
good or better than the one-pass sequential SGP smoother.
"""

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from chirpgp_tpu.infer.common import log_normal_pdf
from chirpgp_tpu.utils.numerics import psd_solve_batched
from chirpgp_tpu.infer.parallel_kf import (
    _FilterElement, _combine_filter, _SmootherElement, _combine_smoother,
    blocked_scan, filter_identity, smoother_identity)
from chirpgp_tpu.models.transitions import Transition, as_transition
from chirpgp_tpu.quad.sigma_points import SigmaPoints

__all__ = ["kf_parallel_tv", "rts_parallel_tv", "slr_transitions",
           "psgp_filter_smoother"]


def kf_parallel_tv(Fs, cs, Sigmas, H, Xi, m0, P0, ys, block_size=None):
    """Parallel-in-time Kalman filter for a time-varying affine SSM
    ``x_k = F_k x_{k-1} + c_k + q_k``; same contract as ``kf_parallel``.

    Shapes: Fs (T, d, d), cs (T, d), Sigmas (T, d, d), ys (T,).
    ``block_size`` selects the blocked scan (single-chip fast path, see
    ``parallel_kf.blocked_scan``).
    """
    T, d = cs.shape
    dtype = m0.dtype
    I = jnp.eye(d, dtype=dtype)

    S = jnp.einsum("i,tij,j->t", H, Sigmas, H) + Xi            # (T,)
    K = jnp.einsum("tij,j->ti", Sigmas, H) / S[:, None]        # (T, d)
    ImKH = I[None] - K[:, :, None] * H[None, None, :]          # (T, d, d)
    A = ImKH @ Fs
    resid = ys - cs @ H                                        # y - H c
    b = cs + K * resid[:, None]
    C = ImKH @ Sigmas
    FTH = jnp.einsum("tji,j->ti", Fs, H)                       # F^T H
    eta = FTH * (resid / S)[:, None]
    J = jnp.einsum("ti,tj->tij", FTH, FTH) / S[:, None, None]

    # First element absorbs the prior.
    m1p = Fs[0] @ m0 + cs[0]
    P1p = Fs[0] @ P0 @ Fs[0].T + Sigmas[0]
    S1 = H @ P1p @ H + Xi
    K1 = P1p @ H / S1
    b1 = m1p + K1 * (ys[0] - H @ m1p)
    C1 = P1p - jnp.outer(K1, K1) * S1

    elems = _FilterElement(
        A=A.at[0].set(jnp.zeros((d, d), dtype)),
        b=b.at[0].set(b1),
        C=C.at[0].set(C1),
        eta=eta.at[0].set(jnp.zeros((d,), dtype)),
        J=J.at[0].set(jnp.zeros((d, d), dtype)))
    if block_size is not None:
        scanned = blocked_scan(_combine_filter, elems,
                               filter_identity(d, dtype), block_size)
    else:
        scanned = jax.lax.associative_scan(_combine_filter, elems)
    mfs, Pfs = scanned.b, scanned.C

    prev_m = jnp.concatenate([m0[None], mfs[:-1]], axis=0)
    prev_P = jnp.concatenate([P0[None], Pfs[:-1]], axis=0)
    mp = jnp.einsum("tij,tj->ti", Fs, prev_m) + cs
    Pp = Fs @ prev_P @ jnp.swapaxes(Fs, -1, -2) + Sigmas
    Spred = jnp.einsum("i,tij,j->t", H, Pp, H) + Xi
    nll = -log_normal_pdf(ys, mp @ H, Spred)
    return mfs, Pfs, jnp.cumsum(nll)


def rts_parallel_tv(Fs, cs, Sigmas, mfs, Pfs,
                    block_size=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Parallel-in-time RTS smoother for the time-varying affine SSM.
    ``Fs[k]``/``cs[k]``/``Sigmas[k]`` map step k-1 -> k (same indexing as
    the filter)."""
    Pf = Pfs[:-1]
    mf = mfs[:-1]
    Fn = Fs[1:]                                     # transition k -> k+1
    cn = cs[1:]
    Pp = Fn @ Pf @ jnp.swapaxes(Fn, -1, -2) + Sigmas[1:]
    ET = psd_solve_batched(Pp, Fn @ Pf)
    E = jnp.swapaxes(ET, -1, -2)
    g = mf - jnp.einsum("tij,tj->ti", E,
                        jnp.einsum("tij,tj->ti", Fn, mf) + cn)
    L = Pf - E @ Pp @ jnp.swapaxes(E, -1, -2)

    elems = _SmootherElement(E, g, L)
    if block_size is not None:
        scanned = blocked_scan(_combine_smoother, elems,
                               smoother_identity(mfs.shape[-1], mfs.dtype),
                               block_size, reverse=True)
    else:
        scanned = jax.lax.associative_scan(_combine_smoother, elems,
                                           reverse=True)
    mss = jnp.einsum("tij,j->ti", scanned.E, mfs[-1]) + scanned.g
    Pss = scanned.E @ Pfs[-1] @ jnp.swapaxes(scanned.E, -1, -2) + scanned.L
    return jnp.concatenate([mss, mfs[-1][None]]), \
        jnp.concatenate([Pss, Pfs[-1][None]])


def slr_transitions(trans, sgps: SigmaPoints, dt, ms, Ps, jitter=0.0):
    """Statistical linear regression of the transition about T nominal
    Gaussians at once: returns (Fs, cs, Lams) with
    ``x_k ~ N(F_k x_{k-1} + c_k, Lam_k)`` the best affine-Gaussian fit at
    nominal ``N(ms[k], Ps[k])``.

    One batched sigma-point evaluation over all T steps (the per-step
    linearizations of the sequential filter, hoisted out of the scan).
    """
    trans = as_transition(trans)
    d = ms.shape[-1]
    chol = jnp.linalg.cholesky(Ps + jitter * jnp.eye(d, dtype=Ps.dtype))
    chi = sgps.gen_sigma_points(ms, chol)            # (T, S, d)
    evals = trans.mean(chi, dt)                      # (T, S, d)
    w = sgps.w.astype(evals.dtype)
    mp = jnp.einsum("s,tsd->td", w, evals)
    dev_in = chi - ms[:, None, :]
    dev_out = evals - mp[:, None, :]
    D = jnp.einsum("s,tsi,tsj->tij", w, dev_in, dev_out)   # Cov[x, f(x)]
    Pout = jnp.einsum("s,tsi,tsj->tij", w, dev_out, dev_out)
    # F = D^T P^{-1} via batched solve.
    Fs = jnp.swapaxes(
        psd_solve_batched(Ps + jitter * jnp.eye(d, dtype=Ps.dtype), D),
        -1, -2)
    cs = mp - jnp.einsum("tij,tj->ti", Fs, ms)
    resid = Pout - Fs @ D
    if trans.const_cov:
        Q = trans.cov_const(dt)
        Lams = resid + Q
    else:
        covs = trans.cov(chi, dt)
        Lams = resid + jnp.einsum("s,tsij->tij", w, covs)
    # Symmetrize the SLR residual (tiny asymmetry from the solve).
    Lams = 0.5 * (Lams + jnp.swapaxes(Lams, -1, -2))
    return Fs, cs, Lams


def psgp_filter_smoother(cond_m_cov, sgps: SigmaPoints, H, Xi, m0, P0, dt,
                         ys, num_iters: int = 8, block_size=None,
                         init_nominal=None):
    """Iterated parallel sigma-point filter + smoother.

    Each iteration: (1) SLR of the transition about the current posterior
    nominal over all T steps (batched), (2) parallel filter + smoother on
    the resulting affine SSM (associative scans, O(log T) depth).  The
    nominal starts at the prior and converges to the iterated posterior
    linearization fixed point.

    ``init_nominal``: optional ``(ms, Ps)`` with shapes (T, d)/(T, d, d)
    -- a data-informed warm start for the first SLR (e.g. one sequential
    filter-smoother pass, or the previous record's posterior).  On
    strongly nonlinear configs a prior nominal can diverge in the first
    iteration (measured: the bats d=10 / freq_scale=1e4 record,
    ROADMAP R8); warm-starting is the standard fix
    in the iterated-smoother literature (posterior-linearization
    smoothers, Garcia-Fernandez et al.; PAPERS.md).  Entry k is the
    linearization Gaussian for the transition INTO step k, i.e. the
    posterior at step k-1 (same alignment as the internal iteration).

    Returns ``(mfs, Pfs, nll, mss, Pss)``.
    """
    trans = as_transition(cond_m_cov)
    T = ys.shape[0]
    d = m0.shape[0]

    # Initial nominal: prior moments, broadcast along time.  The nominal
    # for transition k is the posterior at k-1; index alignment uses the
    # smoothed trajectory shifted right by one.
    if init_nominal is not None:
        ms_nom, Ps_nom = init_nominal
        ms_nom = jnp.asarray(ms_nom, m0.dtype)
        Ps_nom = jnp.asarray(Ps_nom, m0.dtype)
    else:
        ms_nom = jnp.broadcast_to(m0, (T, d))
        Ps_nom = jnp.broadcast_to(P0, (T, d, d))

    def one_iter(carry, _):
        ms_nom, Ps_nom = carry
        Fs, cs, Lams = slr_transitions(trans, sgps, dt, ms_nom, Ps_nom)
        mfs, Pfs, nll = kf_parallel_tv(Fs, cs, Lams, H, Xi, m0, P0, ys,
                                       block_size)
        mss, Pss = rts_parallel_tv(Fs, cs, Lams, mfs, Pfs, block_size)
        # Next nominal for transition k is the smoothed posterior at k-1.
        ms_next = jnp.concatenate([m0[None], mss[:-1]], axis=0)
        Ps_next = jnp.concatenate([P0[None], Pss[:-1]], axis=0)
        return (ms_next, Ps_next), (mfs, Pfs, nll, mss, Pss)

    (_, _), outs = jax.lax.scan(one_iter, (ms_nom, Ps_nom), None,
                                length=num_iters)
    mfs, Pfs, nll, mss, Pss = jax.tree_util.tree_map(
        lambda x: x[-1], outs)
    return mfs, Pfs, nll, mss, Pss
