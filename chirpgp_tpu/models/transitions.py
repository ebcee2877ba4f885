"""Transition (discretization) abstraction.

A :class:`Transition` is the discrete-time conditional law of an SDE over a
step ``dt``: ``X_k | X_{k-1} = u ~ N(mean(u, dt), cov(u, dt))``.

Design: the inference engine consumes transitions through two
structured hooks instead of ``vmap``-ing an opaque ``m_and_cov``:

- ``mean(u, dt)`` must broadcast over arbitrary leading batch axes of ``u``
  (sigma points, Monte-Carlo seeds), so sigma-point propagation is one fused
  batched elementwise program rather than S independent ``(d,d) @ (d,)``
  block-diag matmuls (the reference's shape, ``chirpgp/models.py:295-309``
  under ``jax.vmap`` at ``chirpgp/filters_smoothers.py:478``).
- when ``const_cov`` is set, the process covariance is state-independent and
  the engine skips the per-sigma-point covariance reduction entirely
  (true for the whole chirp model family).

Calling a transition as ``trans(u, dt)`` returns ``(mean, cov)`` for exact
API parity with the reference's ``m_and_cov`` closures.
"""

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["Transition", "as_transition", "batched_mean_and_cov"]


@dataclasses.dataclass(frozen=True)
class Transition:
    """Conditional mean/covariance of a discretized SDE step.

    Attributes
    ----------
    mean : callable ``(..., d), dt -> (..., d)``
        Conditional mean, broadcasting over leading axes.
    cov : callable ``(..., d), dt -> (..., d, d)``
        Conditional covariance.  If ``const_cov``, may ignore the state and
        return a single ``(d, d)`` array.
    const_cov : bool
        Covariance does not depend on the state.
    mean_cf : callable ``(..., d, B), dt -> (..., d, B)`` or None
        Channels-first conditional mean: the state-component axis is
        second-to-last and a (large) batch axis is last.  This is the
        layout the batched kernels use, so that elementwise work runs
        over the large batch axis for these tiny state dimensions (its
        speed against batch-leading layouts is not measured on the H100;
        ROADMAP S6).  When None,
        the batched kernels fall back to transposing around ``mean``.
    """

    mean: Callable
    cov: Callable
    const_cov: bool = False
    mean_cf: Optional[Callable] = None

    def mean_channels_first(self, u_cf: jnp.ndarray, dt) -> jnp.ndarray:
        """Evaluate the conditional mean in channels-first layout
        ``(..., d, B)``, using ``mean_cf`` when available."""
        if self.mean_cf is not None:
            return self.mean_cf(u_cf, dt)
        u = jnp.swapaxes(u_cf, -1, -2)
        return jnp.swapaxes(self.mean(u, dt), -1, -2)

    def __call__(self, u: jnp.ndarray, dt) -> Tuple[jnp.ndarray, jnp.ndarray]:
        m = self.mean(u, dt)
        c = self.cov(u, dt)
        if self.const_cov:
            c = jnp.broadcast_to(c, u.shape[:-1] + c.shape[-2:])
        return m, c

    def cov_const(self, dt) -> jnp.ndarray:
        """The (d, d) state-independent covariance (requires ``const_cov``)."""
        if not self.const_cov:
            raise ValueError("Transition covariance is state-dependent.")
        # State argument is ignored; pass a dummy scalar shape.
        return self.cov(None, dt)


def as_transition(m_and_cov: Callable) -> Transition:
    """Wrap a reference-style ``m_and_cov(u, dt) -> (m, cov)`` single-point
    closure into a :class:`Transition` whose batched evaluation falls back
    to ``vmap``."""
    if isinstance(m_and_cov, Transition):
        return m_and_cov

    def mean(u, dt):
        f = lambda x: m_and_cov(x, dt)[0]
        for _ in range(u.ndim - 1):
            f = jax.vmap(f)
        return f(u)

    def cov(u, dt):
        f = lambda x: m_and_cov(x, dt)[1]
        for _ in range(u.ndim - 1):
            f = jax.vmap(f)
        return f(u)

    return Transition(mean=mean, cov=cov, const_cov=False)


def batched_mean_and_cov(trans: Callable, chi: jnp.ndarray, dt):
    """Evaluate a transition's mean (and, unless constant, covariance) on a
    batch of points ``chi`` of shape ``(..., S, d)``.

    Returns ``(means, covs_or_None, cov_const_or_None)``.
    """
    t = trans if isinstance(trans, Transition) else as_transition(trans)
    means = t.mean(chi, dt)
    if t.const_cov:
        return means, None, t.cov_const(dt)
    return means, t.cov(chi, dt), None
