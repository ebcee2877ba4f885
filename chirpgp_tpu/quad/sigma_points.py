"""Sigma-point quadrature rules for Gaussian integrals.

Approximates :math:`\\int z(x) N(x | m, P) dx \\approx \\sum_i w_i z(m + L \\xi_i)`
with ``L`` the lower Cholesky factor of ``P``.

Design notes
------------
- Rules are immutable NamedTuples whose weights/abscissae are host-side
  NumPy arrays: they enter jitted programs as compile-time literals (never
  as implicit traced arguments), so trace-time validity checks are free.
- ``gen_sigma_points`` and the moment reducers broadcast over arbitrary
  leading batch axes, so a ``vmap``/``shard_map`` over Monte-Carlo seeds turns
  every reduction into a large batched einsum.
- Moment reduction uses the deviation (centered) form
  :math:`P = \\sum_i w_i (z_i - \\bar z)(z_i - \\bar z)^T`, which is
  numerically preferable in float32 to the raw-moment form used by the
  reference (``chirpgp/quadratures.py:120``).

Behavioral parity: reference ``chirpgp/quadratures.py:84-231`` (``SigmaPoints``
NamedTuple with ``cubature``/``gauss_hermite`` factories).  We additionally
implement the unscented rule, which the reference leaves
``NotImplementedError`` (``chirpgp/quadratures.py:153-154``).
"""

import math
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

__all__ = ["SigmaPoints", "cubature", "gauss_hermite", "unscented"]


class SigmaPoints(NamedTuple):
    """A sigma-point rule.

    Attributes
    ----------
    d : int
        Dimension of the Gaussian.
    n_points : int
        Number of sigma points ``S``.
    w : jnp.ndarray (S,)
        Mean weights.
    wc : jnp.ndarray (S,) or None
        Covariance weights if they differ from ``w`` (unscented rule),
        otherwise ``None`` and ``w`` is used for covariances too.
    xi : jnp.ndarray (S, d)
        Unit sigma points (for the standard normal).
    """

    d: int
    n_points: int
    w: jnp.ndarray
    wc: Optional[jnp.ndarray]
    xi: jnp.ndarray

    # ---- factories (also exposed as module-level functions) ----

    @classmethod
    def cubature(cls, d: int) -> "SigmaPoints":
        return cubature(d)

    @classmethod
    def gauss_hermite(cls, d: int, order: int = 3) -> "SigmaPoints":
        return gauss_hermite(d, order)

    @classmethod
    def unscented(cls, d: int, alpha: float = 1.0, beta: float = 0.0,
                  kappa: Optional[float] = None) -> "SigmaPoints":
        return unscented(d, alpha, beta, kappa)

    @property
    def w_cov(self) -> jnp.ndarray:
        return self.w if self.wc is None else self.wc

    # ---- core ops ----

    def gen_sigma_points(self, m: jnp.ndarray, chol_of_P: jnp.ndarray) -> jnp.ndarray:
        r"""Sigma points :math:`\chi_i = m + L \xi_i`.

        Broadcasts over leading batch axes: ``m`` of shape ``(..., d)`` and
        ``chol_of_P`` of shape ``(..., d, d)`` give ``(..., S, d)``.
        """
        # (..., d, d) @ (S, d)^T contracted on the last axis of xi.
        xi = self.xi.astype(chol_of_P.dtype)
        chi = jnp.einsum("...ij,sj->...si", chol_of_P, xi)
        return m[..., None, :] + chi

    def expectation(self, evals: jnp.ndarray) -> jnp.ndarray:
        """Weighted mean over the sigma-point axis.

        ``evals`` has shape ``(..., S, ...)`` with the sigma axis at
        ``-1 - trailing``; we standardize on ``(..., S, d?)`` with the sigma
        axis at position ``-2`` for vectors and ``-3`` for matrices -- for
        the common cases use the dedicated reducers below.  This generic
        version assumes the sigma axis is axis ``-(evals.ndim - w_axis)``
        matching the reference contract ``(S, ...)``.
        """
        return jnp.einsum("i,i...->...", self.w.astype(evals.dtype), evals)

    def expectation_from_nodes(self, v_f, chi: jnp.ndarray) -> jnp.ndarray:
        """Reference-parity helper: weighted mean of ``v_f(chi)`` with the
        sigma axis leading (``chirpgp/quadratures.py:203``)."""
        evals = v_f(chi)
        return jnp.einsum("i,i...->...", self.w.astype(evals.dtype), evals)

    def mean_and_cov(self, evals: jnp.ndarray):
        """Weighted mean and covariance of propagated points.

        Parameters
        ----------
        evals : jnp.ndarray (..., S, d)
            Propagated sigma points (sigma axis second-to-last).

        Returns
        -------
        mean (..., d), cov (..., d, d)
        """
        mean = jnp.einsum("s,...sd->...d", self.w.astype(evals.dtype), evals)
        dev = evals - mean[..., None, :]
        cov = jnp.einsum("s,...si,...sj->...ij",
                         self.w_cov.astype(evals.dtype), dev, dev)
        return mean, cov

    def cross_cov(self, evals_a: jnp.ndarray, evals_b: jnp.ndarray,
                  mean_a: jnp.ndarray, mean_b: jnp.ndarray) -> jnp.ndarray:
        """Weighted cross-covariance ``E[(a - ma)(b - mb)^T]`` over points.

        Shapes: evals ``(..., S, d)``, means ``(..., d)``.
        """
        dev_a = evals_a - mean_a[..., None, :]
        dev_b = evals_b - mean_b[..., None, :]
        return jnp.einsum("s,...si,...sj->...ij",
                          self.w_cov.astype(dev_a.dtype), dev_a, dev_b)


def cubature(d: int) -> SigmaPoints:
    """Spherical cubature rule: ``2d`` points at ``±sqrt(d) e_i`` with equal
    weights ``1/(2d)`` (reference ``chirpgp/quadratures.py:139-150``)."""
    n_points = 2 * d
    w = np.full((n_points,), 1.0 / n_points)
    xi = math.sqrt(d) * np.concatenate([np.eye(d), -np.eye(d)], axis=0)
    return SigmaPoints(d=d, n_points=n_points, w=w, wc=None, xi=xi)


def gauss_hermite(d: int, order: int = 3) -> SigmaPoints:
    """Tensor-grid Gauss--Hermite rule with ``order**d`` points.

    Uses ``numpy.polynomial.hermite.hermgauss`` (Golub--Welsch), which is
    substantially more accurate for high orders than the root-finding used
    by the reference (``chirpgp/quadratures.py:157-196`` via ``np.roots``).
    Scaled for standard-normal expectations: nodes ``sqrt(2) r`` and weights
    ``w / sqrt(pi)`` per dimension.
    """
    roots, weights = np.polynomial.hermite.hermgauss(order)
    nodes_1d = math.sqrt(2.0) * roots
    w_1d = weights / math.sqrt(math.pi)

    grids = np.meshgrid(*([nodes_1d] * d), indexing="ij")
    xi = np.stack([g.reshape(-1) for g in grids], axis=-1)  # (order**d, d)
    wgrids = np.meshgrid(*([w_1d] * d), indexing="ij")
    w = np.prod(np.stack([g.reshape(-1) for g in wgrids], axis=-1), axis=-1)

    return SigmaPoints(d=d, n_points=order ** d, w=w, wc=None, xi=xi)


def unscented(d: int, alpha: float = 1.0, beta: float = 0.0,
              kappa: Optional[float] = None) -> SigmaPoints:
    """Unscented transform (Julier--Uhlmann scaled form), ``2d + 1`` points.

    Not implemented in the reference (``chirpgp/quadratures.py:153-154``);
    provided here as a first-class rule.  Defaults ``alpha=1, beta=0,
    kappa=3-d`` reproduce the classic UT matching fourth moments of the
    Gaussian for ``d<=3``; with ``kappa = 3 - d < 0`` the center weight is
    negative, so covariance weights may be negative (use cov form, not sqrt
    form, with this rule).
    """
    if kappa is None:
        kappa = 3.0 - d
    lam = alpha ** 2 * (d + kappa) - d
    c = d + lam
    xi0 = np.zeros((1, d))
    xs = math.sqrt(c) * np.eye(d)
    xi = np.concatenate([xi0, xs, -xs], axis=0)
    w0m = lam / c
    w0c = lam / c + (1.0 - alpha ** 2 + beta)
    wi = 1.0 / (2.0 * c)
    w = np.concatenate([[w0m], np.full((2 * d,), wi)])
    wc = np.concatenate([[w0c], np.full((2 * d,), wi)])
    return SigmaPoints(d=d, n_points=2 * d + 1, w=w, wc=wc, xi=xi)
