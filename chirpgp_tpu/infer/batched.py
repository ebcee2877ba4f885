"""Batched channels-first square-root filters/smoothers -- the
high-throughput Monte-Carlo path.

These kernels carry the Monte-Carlo batch on the LAST axis, so every
elementwise operation runs over the large batch while the tiny
state/sigma structure is unrolled.  Its speed against the
``vmap``-over-leading-axis formulation of ``chirpgp_tpu.infer.sqrt`` is
not measured on the H100 (ROADMAP S6).

All math is identical to the sqrt module: sigma-point prediction,
Householder triangularization (explicit reflections), 1-D QR measurement
update, joint-factor smoother gain.  Shapes: states ``(d, B)``, factors
``(d, d, B)``, sigma tensors ``(S, d, B)``.
"""

import math
from typing import Tuple

import jax
import jax.numpy as jnp

from chirpgp_tpu.infer.sqrt import _require_nonneg_weights
from chirpgp_tpu.models.transitions import Transition, as_transition
from chirpgp_tpu.quad.sigma_points import SigmaPoints
from chirpgp_tpu.utils.numerics import psd_cholesky

__all__ = ["tria_cf", "sqrt_sgp_filter_batched", "sqrt_sgp_smoother_batched",
           "sqrt_sgp_filter_smoother_batched", "cov_sgp_filter_smoother_batched",
           "gaussian_expectation_batched"]

_LOG_2PI = math.log(2.0 * math.pi)


def tria_cf(M: jnp.ndarray) -> jnp.ndarray:
    """Channels-first Householder triangularization.

    ``M``: (n, d, B) -> upper R (d, d, B) with ``R^T R = M^T M`` per lane.
    """
    n, d = M.shape[0], M.shape[1]
    for j in range(d):
        x = M[j:, j, :]                                   # (n-j, B)
        norm = jnp.sqrt(jnp.sum(x * x, axis=0, keepdims=True))
        sign = jnp.where(x[:1] >= 0, 1.0, -1.0)
        alpha = -sign * norm                              # (1, B)
        v = x.at[0].add(-alpha[0])
        vn2 = jnp.sum(v * v, axis=0, keepdims=True)
        beta = jnp.where(vn2 > 1e-30,
                         2.0 / jnp.where(vn2 > 1e-30, vn2, 1.0), 0.0)
        sub = M[j:, j:, :]                                # (n-j, d-j, B)
        wv = jnp.einsum("nb,nkb->kb", v, sub)
        sub = sub - beta[None] * v[:, None, :] * wv[None]
        # j == 0 updates the whole array, so no scatter is needed.
        M = sub if j == 0 else M.at[j:, j:, :].set(sub)
    R = M[:d]
    # Zero strictly-lower entries (per-lane triu).
    tri = jnp.tril(jnp.ones((d, d), M.dtype), k=-1)
    return R * (1.0 - tri)[:, :, None]


def _predict_cf(trans: Transition, sgps: SigmaPoints, dt, m, L, LqT):
    """Sigma-point sqrt prediction, channels-first.

    m (d, B), L (d, d, B) lower; returns mp (d, B), Up (d, d, B) upper,
    and the propagated deviations for smoother reuse.
    """
    xi = jnp.asarray(sgps.xi, m.dtype)                    # (S, d)
    w = jnp.asarray(sgps.w, m.dtype)                      # (S,)
    sw = jnp.sqrt(w)
    chi = m[None] + jnp.einsum("sj,ijb->sib", xi, L)      # (S, d, B)
    mu = trans.mean_channels_first(chi, dt)               # (S, d, B)
    mp = jnp.einsum("s,sib->ib", w, mu)
    dev = sw[:, None, None] * (mu - mp[None])             # (S, d, B)
    Up = tria_cf(jnp.concatenate([dev, LqT], axis=0))
    return mp, Up, chi, mu, dev


def _update_cf(mp, Up, h_idx: int, sqrt_Xi, y):
    """1-D measurement update, channels-first, for a one-hot measurement
    vector selecting state component ``h_idx`` (the chirp family's H).

    y: (B,).  Returns mf (d, B), Lf (d, d, B) lower, nll increment (B,).
    """
    d, B = mp.shape
    UpH = Up[:, h_idx, :]                                 # (d, B)
    top = jnp.concatenate(
        [jnp.full((1, 1, B), sqrt_Xi, mp.dtype),
         jnp.zeros((1, d, B), mp.dtype)], axis=1)
    bottom = jnp.concatenate([UpH[:, None, :], Up], axis=1)
    R = tria_cf(jnp.concatenate([top, bottom], axis=0))   # (1+d, 1+d, B)
    sS = R[0, 0, :]                                       # (B,)
    wg = R[0, 1:, :]                                      # (d, B)
    Uf = R[1:, 1:, :]
    innov = y - mp[h_idx]
    mf = mp + wg * (innov / sS)[None]
    Lf = jnp.swapaxes(Uf, 0, 1)                           # lower
    nll_inc = 0.5 * (_LOG_2PI + jnp.log(sS * sS) + innov ** 2 / (sS * sS))
    return mf, Lf, nll_inc


def _one_hot_index(H) -> int:
    import numpy as np
    h = np.asarray(H)
    nz = np.nonzero(h)[0]
    if len(nz) != 1 or abs(h[nz[0]] - 1.0) > 0:
        raise ValueError(
            "batched kernels require a one-hot measurement vector H "
            f"(got {h}); use the unbatched filters for general H.")
    return int(nz[0])


def sqrt_sgp_filter_batched(cond_m_cov, sgps: SigmaPoints, H, Xi,
                            m0, P0, dt, yss,
                            unroll: int = 1
                            ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched sqrt sigma-point filter.

    ``yss``: (B, T) measurement sequences.  Returns mfs (T, d, B),
    Lfs (T, d, d, B), nll (T, B) cumulative.  ``unroll`` is forwarded
    to the ``lax.scan`` (bit-identical results; amortizes per-step loop
    overhead on tiny bodies).
    """
    _require_nonneg_weights(sgps, "sqrt_sgp_filter_batched")
    trans = as_transition(cond_m_cov)
    h_idx = _one_hot_index(H)
    B, T = yss.shape
    dtype = yss.dtype
    d = m0.shape[-1]

    sqrt_Xi = jnp.sqrt(jnp.asarray(Xi, dtype))
    L0 = jnp.linalg.cholesky(P0).astype(dtype)
    Lq = psd_cholesky(trans.cov_const(dt)).astype(dtype)
    LqT = jnp.broadcast_to(Lq.T[:, :, None], (d, d, B))
    m_init = jnp.broadcast_to(m0.astype(dtype)[:, None], (d, B))
    L_init = jnp.broadcast_to(L0[:, :, None], (d, d, B))

    ys_t = yss.T                                          # (T, B)

    def step(carry, y):
        m, L, nll = carry
        mp, Up, _, _, _ = _predict_cf(trans, sgps, dt, m, L, LqT)
        mf, Lf, inc = _update_cf(mp, Up, h_idx, sqrt_Xi, y)
        nll = nll + inc
        return (mf, Lf, nll), (mf, Lf, nll)

    init = (m_init, L_init, jnp.zeros((B,), dtype))
    _, (mfs, Lfs, nlls) = jax.lax.scan(step, init, ys_t, unroll=unroll)
    return mfs, Lfs, nlls


def sqrt_sgp_smoother_batched(cond_m_cov, sgps: SigmaPoints, mfs, Lfs,
                              dt) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched sqrt sigma-point smoother over the batched filter output.

    Returns mss (T, d, B), Lss (T, d, d, B).
    """
    _require_nonneg_weights(sgps, "sqrt_sgp_smoother_batched")
    trans = as_transition(cond_m_cov)
    T, d, B = mfs.shape
    dtype = mfs.dtype
    xi = jnp.asarray(sgps.xi, dtype)
    w = jnp.asarray(sgps.w, dtype)
    sw = jnp.sqrt(w)
    Lq = psd_cholesky(trans.cov_const(dt)).astype(dtype)
    LqT = jnp.broadcast_to(Lq.T[:, :, None], (d, d, B))

    def step(carry, elem):
        ms, Ls = carry
        mf, Lf = elem
        chi = mf[None] + jnp.einsum("sj,ijb->sib", xi, Lf)
        mu = trans.mean_channels_first(chi, dt)
        mp = jnp.einsum("s,sib->ib", w, mu)
        dev_pred = sw[:, None, None] * (mu - mp[None])
        dev_prev = sw[:, None, None] * (chi - mf[None])
        M = jnp.concatenate([
            jnp.concatenate([dev_pred, dev_prev], axis=1),
            jnp.concatenate([LqT, jnp.zeros((d, d, B), dtype)], axis=1),
        ], axis=0)                                        # (S+d, 2d, B)
        R = tria_cf(M)                                    # (2d, 2d, B)
        R11, R12, R22 = R[:d, :d], R[:d, d:], R[d:, d:]
        # G = (R11^{-1} R12)^T per lane.
        G = jnp.swapaxes(_backsub_cf(R11, R12, d), 0, 1)  # (d, d, B)
        ms = mf + jnp.einsum("ijb,jb->ib", G, ms - mp)
        GLs = jnp.einsum("ijb,jkb->ikb", G, Ls)
        Ls = jnp.swapaxes(
            tria_cf(jnp.concatenate([jnp.swapaxes(GLs, 0, 1), R22],
                                    axis=0)), 0, 1)
        return (ms, Ls), (ms, Ls)

    init = (mfs[-1], Lfs[-1])
    _, (mss, Lss) = jax.lax.scan(step, init, (mfs[:-1], Lfs[:-1]),
                                 reverse=True)
    return jnp.concatenate([mss, mfs[-1][None]]), \
        jnp.concatenate([Lss, Lfs[-1][None]])


def _backsub_cf(R11: jnp.ndarray, R12: jnp.ndarray, d: int) -> jnp.ndarray:
    """Solve R11 X = R12 per lane (R11 (d, d, B) upper, R12 (d, d, B));
    unrolled back-substitution."""
    X = jnp.zeros_like(R12)
    for i in range(d - 1, -1, -1):
        acc = R12[i]
        for k in range(i + 1, d):
            acc = acc - R11[i, k][None] * X[k]
        X = X.at[i].set(acc / R11[i, i][None])
    return X


def sqrt_sgp_filter_smoother_batched(cond_m_cov, sgps: SigmaPoints, H, Xi,
                                     m0, P0, dt, yss,
                                     return_factors: bool = True,
                                     unroll: int = 1,
                                     out_index: int = None
                                     ) -> Tuple[jnp.ndarray, jnp.ndarray,
                                                jnp.ndarray]:
    """Fused batched sqrt sigma-point filter + smoother.

    Same math as ``sqrt_sgp_filter_batched`` followed by
    ``sqrt_sgp_smoother_batched``, restructured so the smoother's
    sigma-point propagation and its (S+d)-row triangularization happen
    ONCE, inside the forward pass: the joint pre-array
    ``[[dev_pred, dev_prev], [Lq^T, 0]]`` is triangularized per step and
    its R11 block doubles as the filter's predicted factor (the
    Householder reflections for the first d columns see only the first
    block, so R11 == tria([dev_pred; Lq^T]) exactly).  The forward scan
    emits the smoother gain (as ``X = R11^{-1} R12``) and the conditional
    factor R22; the backward scan is then a handful of d x d x B einsums
    plus one 2d-row triangularization -- ~3x cheaper than the standalone
    smoother, which re-propagates sigma points and re-triangularizes
    (S+d, 2d) per step.

    Returns ``(mss (T, d, B), Lss (T, d, d, B) lower, nll (T, B))``.
    Reference behavior contract: ``chirpgp/filters_smoothers.py:446-531``
    (sgp_filter + sgp_smoother), fused on the device.

    ``return_factors=False`` switches the backward pass to the affine
    covariance recursion ``ms = u + G ms'``, ``Ps = D + G Ps' G^T`` with
    ``u = mf - G mp`` and ``D = R22^T R22`` (both emitted by the QR-stable
    forward pass; D is a Gram of the joint factor, PSD by construction).
    That makes the backward scan ~5 ops/step and skips stacking the
    filtered factors; the return value is then ``(mss, Pss, nll)`` with
    FULL covariances instead of Cholesky factors.  The forward pass --
    and hence the f32 accuracy of every ingredient -- is identical.

    ``unroll`` is forwarded to the forward/backward ``lax.scan`` calls:
    the per-step bodies are tiny (d <= 8 algebra on (d, d, B) tiles), so
    unrolling several steps per loop iteration amortizes the scan's
    per-iteration control/dispatch overhead.  Bit-identical results for
    any value.

    ``out_index`` (requires ``return_factors=False``) switches to SLIM
    output: the backward scan emits only the smoothed mean and variance
    of state component ``out_index`` -- ``(v_mean (T, B), v_var (T, B),
    nll (T, B))`` -- instead of full ``(T, d, B)`` means and
    ``(T, d, d, B)`` covariances.  The IF pipeline consumes exactly
    ``mss[:, v, :]`` and ``Pss[:, v, v, :]`` (``g(V)`` posterior via
    Gauss-Hermite), so for d=4 this cuts the backward pass's memory writes
    (d + d^2 = 20 rows/step) 10x to 2 rows/step and frees the
    ``(T, d, d, B)`` output allocation (3.3 GB at B=16384).  The backward
    carry -- and hence every number computed -- is identical to the
    full-output path: the emitted slices are bit-equal to
    ``mss[:, out_index]`` / ``Pss[:, out_index, out_index]``.
    """
    _require_nonneg_weights(sgps, "sqrt_sgp_filter_smoother_batched")
    if out_index is not None and return_factors:
        raise ValueError("out_index (slim output) requires "
                         "return_factors=False")
    trans = as_transition(cond_m_cov)
    h_idx = _one_hot_index(H)
    B, T = yss.shape
    dtype = yss.dtype
    d = m0.shape[-1]

    xi = jnp.asarray(sgps.xi, dtype)
    w = jnp.asarray(sgps.w, dtype)
    sw = jnp.sqrt(w)
    sqrt_Xi = jnp.sqrt(jnp.asarray(Xi, dtype))
    L0 = jnp.linalg.cholesky(P0).astype(dtype)
    Lq = psd_cholesky(trans.cov_const(dt)).astype(dtype)
    LqT = jnp.broadcast_to(Lq.T[:, :, None], (d, d, B))
    zeros_dd = jnp.zeros((d, d, B), dtype)
    m_init = jnp.broadcast_to(m0.astype(dtype)[:, None], (d, B))
    L_init = jnp.broadcast_to(L0[:, :, None], (d, d, B))

    # xiw = sqrt(w) * xi has ORTHONORMAL columns (sum_s w xi xi^T = I for
    # every implemented rule), so dev_prev = xiw @ L^T exactly and the
    # joint pre-array collapses: project dev_pred onto span(xiw)
    # (coefficients A), triangularize only the orthogonal remainder
    # (S rows x d cols -- the same size as the plain filter's pre-array),
    # and finish with a tiny (3d, 2d) triangularization.  Same Gram,
    # ~4x fewer Householder column-updates on the S-row block than the
    # naive (S+d, 2d) joint array.
    xiw = sw[:, None] * xi                                # (S, d)

    def fstep(carry, y):
        m, L, nll = carry
        chi = m[None] + jnp.einsum("sj,ijb->sib", xi, L)
        mu = trans.mean_channels_first(chi, dt)
        mp = jnp.einsum("s,sib->ib", w, mu)
        dev_pred = sw[:, None, None] * (mu - mp[None])
        A = jnp.einsum("sp,sib->pib", xiw, dev_pred)      # (d, d, B)
        dev_perp = dev_pred - jnp.einsum("sp,pib->sib", xiw, A)
        E = tria_cf(dev_perp)                             # (d, d, B)
        M = jnp.concatenate([
            jnp.concatenate([E, zeros_dd], axis=1),
            jnp.concatenate([A, jnp.swapaxes(L, 0, 1)], axis=1),
            jnp.concatenate([LqT, zeros_dd], axis=1),
        ], axis=0)                                        # (3d, 2d, B)
        R = tria_cf(M)                                    # (2d, 2d, B)
        Up = R[:d, :d]
        X = _backsub_cf(Up, R[:d, d:], d)                 # gain G = X^T
        mf, Lf, inc = _update_cf(mp, Up, h_idx, sqrt_Xi, y)
        nll = nll + inc
        if return_factors:
            # Pack per-step (d, B)/(d, d, B) outputs into ONE
            # (2d + 3d^2, B) row, exactly as the covariance branch below,
            # so that B stays the minor dimension of the stacked output.
            packed = jnp.concatenate(
                [mf, mp, Lf.reshape(d * d, B), X.reshape(d * d, B),
                 R[d:, d:].reshape(d * d, B)], axis=0)
            return (mf, Lf, nll), (nll, packed)
        G = jnp.swapaxes(X, 0, 1)
        u = m - jnp.einsum("ijb,jb->ib", G, mp)
        R22 = R[d:, d:]
        D = jnp.einsum("kib,kjb->ijb", R22, R22)
        # One packed (d(2d+1), B) row per step: stacking separate
        # (T, d, d, B) outputs lets XLA's layout assignment pick d as the
        # minor dimension (padded 4 -> 128 on the first backend, a 32x
        # blow-up); packed rows keep B minor.
        packed = jnp.concatenate(
            [u, G.reshape(d * d, B), D.reshape(d * d, B)], axis=0)
        return (mf, Lf, nll), (nll, packed)

    init = (m_init, L_init, jnp.zeros((B,), dtype))

    if return_factors:
        (mf_T, Lf_T, _), (nlls, packs) = jax.lax.scan(fstep, init, yss.T,
                                                      unroll=unroll)

        # Backward element k smooths time k: pair mf_k (row k) with the
        # joint quantities computed at filter iteration k+1 (row k+1).
        # Rows are read with dynamic_index_in_dim inside the body;
        # top-level slicing of the stacked output would trigger the same
        # relayout the packing avoids.
        def bstep(carry, k):
            ms, Ls = carry
            row_k = jax.lax.dynamic_index_in_dim(packs, k, 0,
                                                 keepdims=False)
            row_k1 = jax.lax.dynamic_index_in_dim(packs, k + 1, 0,
                                                  keepdims=False)
            mf_prev = row_k[:d]
            mp = row_k1[d:2 * d]
            X = row_k1[2 * d + d * d:2 * d + 2 * d * d].reshape(d, d, B)
            R22 = row_k1[2 * d + 2 * d * d:].reshape(d, d, B)
            G = jnp.swapaxes(X, 0, 1)
            ms = mf_prev + jnp.einsum("ijb,jb->ib", G, ms - mp)
            GLs = jnp.einsum("ijb,jkb->ikb", G, Ls)
            Ls = jnp.swapaxes(
                tria_cf(jnp.concatenate([jnp.swapaxes(GLs, 0, 1), R22],
                                        axis=0)), 0, 1)
            return (ms, Ls), (ms, Ls)

        _, (mss, Lss) = jax.lax.scan(bstep, (mf_T, Lf_T),
                                     jnp.arange(T - 1), reverse=True,
                                     unroll=unroll)
        mss = jnp.concatenate([mss, mf_T[None]])
        Lss = jnp.concatenate([Lss, Lf_T[None]])
        return mss, Lss, nlls

    (mf_T, Lf_T, _), (nlls, packs) = jax.lax.scan(fstep, init, yss.T,
                                                  unroll=unroll)

    # The maps emitted at iteration t smooth time t-1 given time t, so
    # backward element k uses row k+1: the packed rows [1:] feed the
    # reverse scan directly as xs (native leading-axis slicing -- only
    # ONE row is needed per step in this branch, unlike the factor
    # branch above, which pairs rows k and k+1 and therefore gathers
    # with dynamic_index_in_dim).
    def bstep_cov(carry, row):
        ms, Ps = carry
        u = row[:d]
        G = row[d:d + d * d].reshape(d, d, B)
        D = row[d + d * d:].reshape(d, d, B)
        ms = u + jnp.einsum("ijb,jb->ib", G, ms)
        Ps = D + jnp.einsum(
            "ikb,kjb->ijb", G, jnp.einsum("ikb,jkb->ijb", Ps, G))
        if out_index is not None:
            return (ms, Ps), (ms[out_index], Ps[out_index, out_index])
        return (ms, Ps), (ms, Ps)

    Pf_T = jnp.einsum("ikb,jkb->ijb", Lf_T, Lf_T)
    _, (mss, Pss) = jax.lax.scan(bstep_cov, (mf_T, Pf_T),
                                 packs[1:], reverse=True,
                                 unroll=unroll)
    if out_index is not None:
        v_mean = jnp.concatenate([mss, mf_T[out_index][None]])
        v_var = jnp.concatenate([Pss, Pf_T[out_index, out_index][None]])
        return v_mean, v_var, nlls
    mss = jnp.concatenate([mss, mf_T[None]])
    Pss = jnp.concatenate([Pss, Pf_T[None]])
    return mss, Pss, nlls


def _chol_cf(P: jnp.ndarray, d: int, eps: float = 1e-30) -> jnp.ndarray:
    """Channels-first unrolled Cholesky: P (d, d, B) SPD per lane ->
    lower L (d, d, B).  A lane whose pivot has gone non-positive through
    f32 roundoff gets a TRULY degenerate factor: the diagonal is clamped
    to sqrt(eps) and the column below the clamped pivot is zeroed (a
    clamped pivot alone would put 1/sqrt(eps) ~ 1e15 into the
    off-diagonal entries and blow up downstream anyway)."""
    rows = [[None] * d for _ in range(d)]
    for j in range(d):
        acc = P[j, j]
        for k in range(j):
            acc = acc - rows[j][k] * rows[j][k]
        ok = acc > eps
        Ljj = jnp.sqrt(jnp.maximum(acc, eps))
        rows[j][j] = Ljj
        inv = jnp.where(ok, 1.0 / Ljj, 0.0)
        for i in range(j + 1, d):
            acc = P[i, j]
            for k in range(j):
                acc = acc - rows[i][k] * rows[j][k]
            rows[i][j] = acc * inv
    zero = jnp.zeros_like(P[0, 0])
    return jnp.stack([
        jnp.stack([rows[i][j] if j <= i else zero for j in range(d)])
        for i in range(d)])


def _spd_solve_cf(Lp: jnp.ndarray, C: jnp.ndarray, d: int) -> jnp.ndarray:
    """Solve G (Lp Lp^T) = C per lane: G = C Lp^{-T} Lp^{-1} with
    ``Lp`` (d, d, B) lower, ``C`` (d, d, B); two unrolled substitutions
    acting on the columns of C^T."""
    # Y Lp^T = C  ->  forward substitution on columns of Y.
    Y = [None] * d
    for j in range(d):
        acc = C[:, j]
        for k in range(j):
            acc = acc - Y[k] * Lp[j, k][None]
        Y[j] = acc / Lp[j, j][None]
    # G Lp = Y -> back substitution.
    G = [None] * d
    for j in range(d - 1, -1, -1):
        acc = Y[j]
        for k in range(j + 1, d):
            acc = acc - G[k] * Lp[k, j][None]
        G[j] = acc / Lp[j, j][None]
    return jnp.stack(G, axis=1)                           # (d, d, B)


def cov_sgp_filter_smoother_batched(cond_m_cov, sgps: SigmaPoints, H, Xi,
                                    m0, P0, dt, yss,
                                    unroll: int = 1
                                    ) -> Tuple[jnp.ndarray, jnp.ndarray,
                                               jnp.ndarray]:
    """Fused batched sigma-point filter + smoother in covariance form --
    the high-throughput option.

    Per step the sqrt path pays ~30 sequential Householder column-update
    ops on the (S+d)-row pre-array; this path replaces them with ONE
    weighted Gram contraction (``Pp = dev^T diag(w) dev + Q``, PSD by
    construction) plus an unrolled channels-first Cholesky on tiny
    (d, d, B) tiles, and propagates plain covariances.  f32-safety comes
    from the Gram construction (never a K S K^T subtraction for the
    prediction) plus a clamped Cholesky diagonal; the measurement update
    ``Pf = Pp - p_h p_h^T / s`` is the exact Schur complement, PSD up to
    roundoff.  Validated against the sqrt path; for ill-conditioned
    models prefer ``sqrt_sgp_filter_smoother_batched``.

    Returns ``(mss (T, d, B), Pss (T, d, d, B) full covariances, nll
    (T, B) cumulative)``.  Note: covariances, not Cholesky factors.
    """
    _require_nonneg_weights(sgps, "cov_sgp_filter_smoother_batched")
    trans = as_transition(cond_m_cov)
    h_idx = _one_hot_index(H)
    B, T = yss.shape
    dtype = yss.dtype
    d = m0.shape[-1]

    xi = jnp.asarray(sgps.xi, dtype)                      # (S, d)
    w = jnp.asarray(sgps.w, dtype)                        # (S,)
    wxi = w[:, None] * xi                                 # (S, d)
    Xi_s = jnp.asarray(Xi, dtype)
    Qc = trans.cov_const(dt).astype(dtype)[:, :, None]    # (d, d, 1)
    m_init = jnp.broadcast_to(m0.astype(dtype)[:, None], (d, B))
    P_init = jnp.broadcast_to(P0.astype(dtype)[:, :, None], (d, d, B))

    # The backward recursion is affine in the smoothed moments:
    #   ms_k = u_{k+1} + G_{k+1} ms_{k+1},
    #   Ps_k = D_{k+1} + G_{k+1} Ps_{k+1} G_{k+1}^T,
    # with u = mf - G mp and D = Pf - G Pp G^T.  The forward scan emits
    # (u, G, D) directly, shifted one step so the backward scan consumes
    # them without host-side reslicing (no extra (T, d, d, B) copies).
    def fstep(carry, y):
        m, P, nll = carry
        L = _chol_cf(P, d)
        chi = m[None] + jnp.einsum("sj,ijb->sib", xi, L)
        mu = trans.mean_channels_first(chi, dt)
        mp = jnp.einsum("s,sib->ib", w, mu)
        dev = mu - mp[None]                               # (S, d, B)
        Pp = jnp.einsum("sib,s,sjb->ijb", dev, w, dev) + Qc
        # Cross-cov C = Cov[x_{k-1}, x_k] = L @ A with
        # A = sum_s w xi_s dev_s^T (chi - m = L xi_s).
        A = jnp.einsum("sp,sjb->pjb", wxi, dev)
        C = jnp.einsum("ikb,kjb->ijb", L, A)
        Lp = _chol_cf(Pp, d)
        G = _spd_solve_cf(Lp, C, d)                       # C Pp^{-1}
        u = m - jnp.einsum("ijb,jb->ib", G, mp)
        W = jnp.einsum("ikb,kjb->ijb", G, Lp)
        D = P - jnp.einsum("ikb,jkb->ijb", W, W)
        s = Pp[h_idx, h_idx] + Xi_s                       # (B,)
        p_h = Pp[:, h_idx]                                # (d, B)
        innov = y - mp[h_idx]
        mf = mp + p_h * (innov / s)[None]
        Pf = Pp - p_h[:, None, :] * p_h[None, :, :] / s[None, None]
        nll = nll + 0.5 * (_LOG_2PI + jnp.log(s) + innov ** 2 / s)
        return (mf, Pf, nll), (nll, u, G, D)

    init = (m_init, P_init, jnp.zeros((B,), dtype))
    (mf_T, Pf_T, _), (nlls, us, Gs, Ds) = jax.lax.scan(fstep, init, yss.T,
                                                       unroll=unroll)
    # The maps emitted at filter iteration t smooth time t-1 given time t;
    # backward element k in [0, T-2] therefore uses iteration k+1's maps.
    us, Gs, Ds = us[1:], Gs[1:], Ds[1:]

    def bstep(carry, elem):
        ms, Ps = carry
        u, G, D = elem
        ms = u + jnp.einsum("ijb,jb->ib", G, ms)
        Ps = D + jnp.einsum(
            "ikb,kjb->ijb", G, jnp.einsum("ikb,jkb->ijb", Ps, G))
        return (ms, Ps), (ms, Ps)

    _, (mss, Pss) = jax.lax.scan(bstep, (mf_T, Pf_T), (us, Gs, Ds),
                                 reverse=True, unroll=unroll)
    mss = jnp.concatenate([mss, mf_T[None]])
    Pss = jnp.concatenate([Pss, Pf_T[None]])
    return mss, Pss, nlls


def gaussian_expectation_batched(ms, stds, func=None, order: int = 10):
    """E[f(V)] for channels-first (T, B) means/stds via Gauss-Hermite."""
    if func is None:
        from chirpgp_tpu.models.bijections import g as func
    from chirpgp_tpu.quad.sigma_points import gauss_hermite
    rule = gauss_hermite(1, order)
    nodes = jnp.asarray(rule.xi[:, 0], ms.dtype)
    ws = jnp.asarray(rule.w, ms.dtype)
    chi = ms[None] + stds[None] * nodes[:, None, None]    # (S, T, B)
    return jnp.einsum("s,stb->tb", ws, func(chi))
