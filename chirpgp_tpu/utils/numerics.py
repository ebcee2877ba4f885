"""Numerical helpers shared across the framework."""

import jax.numpy as jnp

__all__ = ["phi1", "ou_variance", "psd_cholesky", "psd_solve",
           "solve_small", "psd_solve_batched"]


def phi1(x: jnp.ndarray) -> jnp.ndarray:
    r"""Smooth evaluation of :math:`\phi_1(x) = (1 - e^{-x}) / x`.

    Replaces the reference's ``lax.cond(lam == 0., ...)`` branch on the
    damped-harmonic transition variance (``chirpgp/models.py:302-308``) with
    a single smooth expression: differentiable at ``x = 0`` (the ``cond``
    kills gradients and breaks under ``vmap`` batching) and free of the
    0/0 at small ``x`` via a Taylor switch.
    """
    small = jnp.abs(x) < 1e-4
    x_safe = jnp.where(small, 1.0, x)
    exact = -jnp.expm1(-x_safe) / x_safe
    taylor = 1.0 - x / 2.0 + x * x / 6.0
    return jnp.where(small, taylor, exact)


def ou_variance(b, lam, dt):
    r"""Stationary-increment variance of a damped (OU-like) channel:
    :math:`b^2 (1 - e^{-2\lambda dt}) / (2\lambda)`, smoothly equal to
    ``b^2 dt`` at ``lam = 0``."""
    return b ** 2 * dt * phi1(2.0 * lam * dt)


def psd_cholesky(P, eps: float = 1e-30):
    """Lower Cholesky-like factor of a PSD matrix that may be SINGULAR.

    ``jnp.linalg.cholesky`` returns NaN on exactly-singular inputs (e.g.
    the La Scala chirp model's conditional covariance, whose chirp block
    has no dispersion -- reference ``models.py:181``); square-root
    filters only need ANY factor with L L^T = P, and QR pre-arrays are
    happy with zero rows.  This unrolled Cholesky zeroes the pivot and
    its column when the pivot falls below ``eps`` (the same degenerate
    contract as the batched channels-first kernels), so L L^T still
    reproduces the nonsingular block exactly.  Differentiable: clamped
    pivots contribute zero gradient.

    Accepts (..., d, d); d must be static.
    """
    import jax.numpy as jnp

    d = P.shape[-1]
    rows = [[None] * d for _ in range(d)]
    for j in range(d):
        acc = P[..., j, j]
        for k in range(j):
            acc = acc - rows[j][k] * rows[j][k]
        ok = acc > eps
        Ljj = jnp.where(ok, jnp.sqrt(jnp.maximum(acc, eps)), 0.0)
        inv = jnp.where(ok, 1.0 / jnp.where(ok, Ljj, 1.0), 0.0)
        rows[j][j] = Ljj
        for i in range(j + 1, d):
            acc2 = P[..., i, j]
            for k in range(j):
                acc2 = acc2 - rows[i][k] * rows[j][k]
            rows[i][j] = acc2 * inv
    zero = jnp.zeros_like(P[..., 0, 0])
    return jnp.stack(
        [jnp.stack([rows[i][j] if j <= i else zero for j in range(d)],
                   axis=-1) for i in range(d)], axis=-2)


def psd_solve(P, B, eps: float = 1e-30):
    """Solve ``P X = B`` for PSD ``P`` that may be singular in f32.

    Factors ``P = L L^T`` with :func:`psd_cholesky` and runs forward/back
    substitution that treats clamped (zero) pivots as zero contribution --
    i.e. the solve acts as the pseudo-inverse on the degenerate subspace
    and is exact on PD inputs.  ``jax.scipy.linalg.cho_solve`` by contrast
    returns NaN on any indefinite/singular input, which kills the
    covariance-form smoothers on models with noise-free blocks (La Scala,
    reference ``models.py:181``) after thousands of f32 steps.

    ``P``: (d, d); ``B``: (d,) or (d, k).  d must be static.
    """
    import jax.numpy as jnp

    L = psd_cholesky(P, eps)
    d = P.shape[-1]
    vec = B.ndim == 1
    Bm = B[:, None] if vec else B
    piv_ok = [L[j, j] > 0 for j in range(d)]
    inv = [jnp.where(piv_ok[j], 1.0 / jnp.where(piv_ok[j], L[j, j], 1.0),
                     0.0) for j in range(d)]
    # forward: L Y = B
    Y = [None] * d
    for j in range(d):
        acc = Bm[j]
        for k in range(j):
            acc = acc - L[j, k] * Y[k]
        Y[j] = acc * inv[j]
    # backward: L^T X = Y
    X = [None] * d
    for j in range(d - 1, -1, -1):
        acc = Y[j]
        for k in range(j + 1, d):
            acc = acc - L[k, j] * X[k]
        X[j] = acc * inv[j]
    out = jnp.stack(X, axis=0)
    return out[:, 0] if vec else out


def solve_small(A, B):
    """Batched solve ``A X = B`` for SMALL static ``d`` by unrolled
    Gaussian elimination without pivoting.

    ``A``: (..., d, d); ``B``: (..., d, k); batched over the leading
    axes.  ``jnp.linalg.solve`` lowers tiny batched systems to a
    general pivoted LU routine; this unrolled form is pure elementwise
    arithmetic over the batch.  Which is faster on the H100 is not
    measured (ROADMAP S5, D5).

    No pivoting: intended for the well-conditioned systems of the
    parallel-scan combines -- ``I + C J`` with ``C``, ``J`` PSD (all
    eigenvalues >= 1 in exact arithmetic) and SPD covariance solves,
    where the leading principal minors stay positive.  Do not use on
    general indefinite matrices.
    """
    d = A.shape[-1]
    k = B.shape[-1]
    if d == 2:
        # Closed-form adjugate: 2x2 is by far the hottest case (M32
        # filtering elements), and the tiny expression keeps the HLO
        # small inside scan bodies (the unrolled-GE form's op count is
        # multiplied through the blocked-scan structure at T=25000).
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, e = A[..., 1, 0], A[..., 1, 1]
        det = a * e - b * c
        inv_det = 1.0 / det
        r0 = (e[..., None] * B[..., 0, :] - b[..., None] * B[..., 1, :])
        r1 = (-c[..., None] * B[..., 0, :] + a[..., None] * B[..., 1, :])
        return jnp.stack([r0, r1], axis=-2) * inv_det[..., None, None]
    # Work on unstacked scalar lanes: M[i][j] are (...,) arrays.
    M = [[A[..., i, j] for j in range(d)] for i in range(d)]
    X = [[B[..., i, j] for j in range(k)] for i in range(d)]
    for i in range(d):
        inv = 1.0 / M[i][i]
        for j in range(i + 1, d):
            M[i][j] = M[i][j] * inv
        for j in range(k):
            X[i][j] = X[i][j] * inv
        for r in range(i + 1, d):
            f = M[r][i]
            for j in range(i + 1, d):
                M[r][j] = M[r][j] - f * M[i][j]
            for j in range(k):
                X[r][j] = X[r][j] - f * X[i][j]
    for i in range(d - 2, -1, -1):
        for r in range(i + 1, d):
            f = M[i][r]
            for j in range(k):
                X[i][j] = X[i][j] - f * X[r][j]
    return jnp.stack([jnp.stack(row, axis=-1) for row in X], axis=-2)


def psd_solve_batched(P, B, eps: float = 1e-30):
    """Batched solve ``P X = B`` for SPD/PSD ``P`` with small static d.

    ``P``: (..., d, d); ``B``: (..., d, k).  Unrolled Cholesky
    (:func:`psd_cholesky`, degenerate-safe) + unrolled substitutions --
    the batched-leading-axes counterpart of :func:`psd_solve`, for the
    same reason as :func:`solve_small` (elementwise arithmetic in place
    of the general LU lowering of ``jnp.linalg.solve``).
    """
    L = psd_cholesky(P, eps)
    d = P.shape[-1]
    k = B.shape[-1]
    diag = [L[..., j, j] for j in range(d)]
    inv = [jnp.where(diag[j] > 0,
                     1.0 / jnp.where(diag[j] > 0, diag[j], 1.0), 0.0)
           for j in range(d)]
    Bl = [[B[..., i, j] for j in range(k)] for i in range(d)]
    Y = [None] * d
    for j in range(d):
        acc = Bl[j]
        for kk in range(j):
            acc = [a - L[..., j, kk] * y for a, y in zip(acc, Y[kk])]
        Y[j] = [a * inv[j] for a in acc]
    X = [None] * d
    for j in range(d - 1, -1, -1):
        acc = Y[j]
        for kk in range(j + 1, d):
            acc = [a - L[..., kk, j] * x for a, x in zip(acc, X[kk])]
        X[j] = [a * inv[j] for a in acc]
    return jnp.stack([jnp.stack(row, axis=-1) for row in X], axis=-2)
