"""Parallel-in-time Kalman filtering and RTS smoothing via
``jax.lax.associative_scan``.

The reference's filters are O(T) sequential ``lax.scan`` loops
(``chirpgp/filters_smoothers.py:183,263,489``) -- every step is a
tiny-matrix op, so a long sequence leaves an accelerator mostly idle.  Here the LGSSM
filter/smoother is reformulated as an associative prefix operation over
conditional-Gaussian elements (Sarkka & Garcia-Fernandez 2021, *Temporal
parallelization of Bayesian smoothers*; see PAPERS.md), giving O(log T)
depth with all element combinations running as batched (T, d, d) einsums.

This is the framework's sequence-parallel path: for very long records the
time axis can additionally be sharded over a device mesh (the SSM analog of
context parallelism).
"""

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from chirpgp_tpu.infer.common import log_normal_pdf
from chirpgp_tpu.utils.numerics import psd_solve_batched, solve_small

__all__ = ["kf_parallel", "rts_parallel", "kf_rts_parallel",
           "blocked_scan"]


def blocked_scan(combine, elems, identity, block_size, reverse=False):
    """Blocked (chunked) prefix scan: ``lax.scan`` within blocks,
    associative scan across block totals.

    ``jax.lax.associative_scan`` over T tiny (d, d) elements costs
    O(T log T) work in ~2 log2(T) full-array passes, and its
    non-power-of-two odd/even recursion bloats to hundreds of
    slice/concat kernels (on the first backend it lost to the O(T)
    sequential scan; not measured on the H100, ROADMAP S5).  The blocked
    shape is this one: split T into ``nb`` blocks of ``block_size``, run ONE
    sequential ``lax.scan`` of depth ``block_size`` whose every step
    combines ``nb`` elements at once (the time axis becomes the
    vector axis), combine the ``nb`` block totals with a short
    associative scan, and distribute the block offsets with a single
    T-wide combine.  Depth ``block_size + log2(nb) + 1`` instead of T,
    with full vector utilisation throughout -- the same
    local-scan + prefix-exchange decomposition as the cross-chip
    time-sharded path (``parallel_sharded._sharded_assoc_scan``), with
    blocks in place of devices.

    ``combine`` must be associative and batched on axis 0 (both
    ``_combine_filter`` and ``_combine_smoother`` are); ``identity`` is
    a pytree of per-element identity leaves (no leading T axis) used
    for tail padding and the exclusive offset.  ``reverse=True``
    computes suffix aggregates under the same operand convention as
    ``associative_scan(..., reverse=True)`` (first operand = suffix
    aggregate).
    """
    T = jax.tree.leaves(elems)[0].shape[0]
    if reverse:
        elems = jax.tree.map(lambda e: e[::-1], elems)
    C = min(int(block_size), T)
    nb = -(-T // C)
    pad = nb * C - T
    if pad:
        elems = jax.tree.map(
            lambda e, i: jnp.concatenate(
                [e, jnp.broadcast_to(i, (pad,) + e.shape[1:])]),
            elems, identity)
    # (T, ...) -> (C, nb, ...): scan over the within-block index, with
    # the block index riding the combine's batch axis.
    blk = jax.tree.map(
        lambda e: e.reshape(nb, C, *e.shape[1:]).swapaxes(0, 1), elems)
    init = jax.tree.map(
        lambda i: jnp.broadcast_to(i, (nb,) + i.shape), identity)

    def step(carry, e):
        new = combine(carry, e)
        return new, new

    totals, prefixes = jax.lax.scan(step, init, blk)
    # Exclusive cross-block offsets (nb is small: log2(nb) passes).
    # Pad nb to a power of two first: associative_scan's non-power-of-2
    # odd/even recursion lowers to a long chain of slice/concat kernels
    # (the measured slow path of the flat scan).
    nb2 = 1 << (nb - 1).bit_length()
    if nb2 != nb:
        totals = jax.tree.map(
            lambda t, i: jnp.concatenate(
                [t, jnp.broadcast_to(i, (nb2 - nb,) + t.shape[1:])]),
            totals, identity)
    inc = jax.lax.associative_scan(combine, totals)
    offsets = jax.tree.map(
        lambda i, s: jnp.concatenate(
            [jnp.broadcast_to(i, (1,) + i.shape), s[:nb - 1]]),
        identity, inc)
    flat_p = jax.tree.map(
        lambda p: p.swapaxes(0, 1).reshape((nb * C,) + p.shape[2:]),
        prefixes)
    flat_o = jax.tree.map(
        lambda o: jnp.broadcast_to(
            o[:, None], (nb, C) + o.shape[1:]).reshape(
                (nb * C,) + o.shape[1:]),
        offsets)
    out = combine(flat_o, flat_p)
    out = jax.tree.map(lambda x: x[:T], out)
    if reverse:
        out = jax.tree.map(lambda x: x[::-1], out)
    return out


class _FilterElement(NamedTuple):
    A: jnp.ndarray   # (T, d, d)
    b: jnp.ndarray   # (T, d)
    C: jnp.ndarray   # (T, d, d)
    eta: jnp.ndarray  # (T, d)
    J: jnp.ndarray   # (T, d, d)


def _combine_filter(a: _FilterElement, b: _FilterElement) -> _FilterElement:
    """Associative combination of filtering elements (batched on axis 0)."""
    d = a.A.shape[-1]
    I = jnp.eye(d, dtype=a.A.dtype)
    # M = (I + C_a J_b)^{-1}.  solve_small (unrolled, no pivoting) instead
    # of jnp.linalg.solve's general pivoted LU lowering; I + C J with
    # PSD C, J is exactly the well-conditioned case it requires.
    M = solve_small(I + a.C @ b.J, jnp.broadcast_to(I, a.C.shape))
    AjM = b.A @ M
    A = AjM @ a.A
    bb = (AjM @ (a.b + jnp.einsum("...ij,...j->...i", a.C, b.eta))[..., None]
          )[..., 0] + b.b
    C = AjM @ a.C @ jnp.swapaxes(b.A, -1, -2) + b.C
    N = solve_small(I + b.J @ a.C, jnp.broadcast_to(I, a.C.shape))
    AiTN = jnp.swapaxes(a.A, -1, -2) @ N
    eta = (AiTN @ (b.eta - jnp.einsum("...ij,...j->...i", b.J, a.b))[..., None]
           )[..., 0] + a.eta
    J = AiTN @ b.J @ a.A + a.J
    return _FilterElement(A, bb, C, eta, J)


def _filter_elements(F, Sigma, H, Xi, m0, P0, ys) -> _FilterElement:
    """Per-step conditional-Gaussian elements for a time-invariant LGSSM."""
    T = ys.shape[0]
    d = m0.shape[0]
    dtype = m0.dtype
    I = jnp.eye(d, dtype=dtype)

    # Generic element (k >= 2): built from (F, Sigma, H, Xi, y_k).
    S = H @ Sigma @ H + Xi                        # scalar
    K = Sigma @ H / S                             # (d,)
    A_g = (I - jnp.outer(K, H)) @ F
    C_g = (I - jnp.outer(K, H)) @ Sigma
    FTH = F.T @ H                                 # (d,)
    J_g = jnp.outer(FTH, FTH) / S

    A = jnp.broadcast_to(A_g, (T, d, d))
    b = ys[:, None] * K[None, :]                  # K y_k
    C = jnp.broadcast_to(C_g, (T, d, d))
    eta = ys[:, None] * (FTH / S)[None, :]
    J = jnp.broadcast_to(J_g, (T, d, d))

    # First element absorbs the prior: predict from (m0, P0) then update.
    m1p = F @ m0
    P1p = F @ P0 @ F.T + Sigma
    S1 = H @ P1p @ H + Xi
    K1 = P1p @ H / S1
    b1 = m1p + K1 * (ys[0] - H @ m1p)
    C1 = P1p - jnp.outer(K1, K1) * S1

    A = A.at[0].set(jnp.zeros((d, d), dtype))
    b = b.at[0].set(b1)
    C = C.at[0].set(C1)
    eta = eta.at[0].set(jnp.zeros((d,), dtype))
    J = J.at[0].set(jnp.zeros((d, d), dtype))
    return _FilterElement(A, b, C, eta, J)


def filter_identity(d: int, dtype) -> _FilterElement:
    """Two-sided identity of :func:`_combine_filter` (verified in
    tests): the conditional-Gaussian element of a deterministic
    identity transition with no observation."""
    I = jnp.eye(d, dtype=dtype)
    z = jnp.zeros((d,), dtype=dtype)
    Z = jnp.zeros((d, d), dtype=dtype)
    return _FilterElement(I, z, Z, z, Z)


def kf_parallel(F, Sigma, H, Xi, m0, P0, ys,
                block_size=None) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Parallel-in-time Kalman filter; same contract as
    :func:`chirpgp_tpu.infer.filters.kf` (means, covariances, cumulative
    NLL).  ``block_size`` selects the blocked scan (see
    :func:`blocked_scan`) -- the fast single-chip form; ``None`` keeps
    the flat ``associative_scan`` (minimal depth, the cross-chip
    building block)."""
    elems = _filter_elements(F, Sigma, H, Xi, m0, P0, ys)
    if block_size is not None:
        scanned = blocked_scan(_combine_filter, elems,
                               filter_identity(m0.shape[0], m0.dtype),
                               block_size)
    else:
        scanned = jax.lax.associative_scan(_combine_filter, elems)
    mfs, Pfs = scanned.b, scanned.C

    # NLL from one batched predicted-moment pass (no sequential dependency).
    prev_m = jnp.concatenate([m0[None], mfs[:-1]], axis=0)        # (T, d)
    prev_P = jnp.concatenate([P0[None], Pfs[:-1]], axis=0)        # (T, d, d)
    mp = jnp.einsum("ij,tj->ti", F, prev_m)
    Pp = jnp.einsum("ij,tjk,lk->til", F, prev_P, F) + Sigma
    S = jnp.einsum("i,tij,j->t", H, Pp, H) + Xi
    pred = mp @ H
    nll = -log_normal_pdf(ys, pred, S)
    return mfs, Pfs, jnp.cumsum(nll)


class _SmootherElement(NamedTuple):
    E: jnp.ndarray   # (T-1, d, d)
    g: jnp.ndarray   # (T-1, d)
    L: jnp.ndarray   # (T-1, d, d)


def smoother_identity(d: int, dtype) -> "_SmootherElement":
    """Two-sided identity of :func:`_combine_smoother`."""
    return _SmootherElement(jnp.eye(d, dtype=dtype),
                            jnp.zeros((d,), dtype=dtype),
                            jnp.zeros((d, d), dtype=dtype))


def _combine_smoother(a: _SmootherElement, b: _SmootherElement) -> _SmootherElement:
    """Composition of affine-Gaussian backward maps.

    Under ``associative_scan(..., reverse=True)`` the first operand ``a`` is
    the suffix aggregate (later time steps) and ``b`` the newly absorbed
    earlier element, so the result is ``f_b \\circ f_a``.
    """
    E = b.E @ a.E
    g = jnp.einsum("...ij,...j->...i", b.E, a.g) + b.g
    L = b.E @ a.L @ jnp.swapaxes(b.E, -1, -2) + b.L
    return _SmootherElement(E, g, L)


def rts_parallel(F, Sigma, mfs, Pfs,
                 block_size=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Parallel-in-time RTS smoother; same contract as
    :func:`chirpgp_tpu.infer.smoothers.rts`.  ``block_size`` as in
    :func:`kf_parallel`."""
    Pf = Pfs[:-1]                                  # (T-1, d, d)
    mf = mfs[:-1]
    Pp = jnp.einsum("ij,tjk,lk->til", F, Pf, F) + Sigma
    # Gain E = Pf F^T Pp^{-1}, solved batched: E^T = Pp^{-1} F Pf
    # (unrolled SPD solve -- see solve_small's rationale).
    ET = psd_solve_batched(Pp, jnp.einsum("ij,tjk->tik", F, Pf))
    E = jnp.swapaxes(ET, -1, -2)
    g = mf - jnp.einsum("tij,jk,tk->ti", E, F, mf)
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


def kf_rts_parallel(F, Sigma, H, Xi, m0, P0, ys, block_size=None):
    """Fused parallel filter + smoother pass."""
    mfs, Pfs, nll = kf_parallel(F, Sigma, H, Xi, m0, P0, ys, block_size)
    mss, Pss = rts_parallel(F, Sigma, mfs, Pfs, block_size)
    return mfs, Pfs, nll, mss, Pss
