"""Gauss--Newton and Levenberg--Marquardt nonlinear least squares.

Used by the polynomial-IF baseline (reference ``chirpgp/gauss_newton.py``,
``classical_methods.py:179-192``), redesigned for the XLA execution
model rather than the reference's host-looped normal equations:

- The whole optimization is ONE ``lax.while_loop`` program
  (:func:`gauss_newton_while`, :func:`levenberg_marquardt_while`), so it
  jits, vmaps over a Monte-Carlo batch axis (all seeds advance in
  lockstep), and differentiates if needed.
- Each iteration solves the linearized least-squares subproblem by **QR
  of the Jacobian** (thin-QR + triangular solve) instead of forming
  J^T J and solving normal equations -- square-root style, consistent
  with the framework's f32-safe inference kernels, and better
  conditioned (kappa(J) vs kappa(J)^2).
- LM damping is the augmented-rows formulation: append
  ``sqrt(mu) * diag(||J_col||)`` rows to J and zeros to the residual, QR
  the stacked system.  Marquardt scaling falls out of the column norms;
  no ``diagflat`` / matrix solve.

:func:`gauss_newton` / :func:`levenberg_marquardt` keep the host-facing
tuple contract ``(params, obj_trace)`` of the reference API as thin
wrappers that trim the fixed-size trace.
"""

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

__all__ = ["NLSResult", "gauss_newton_while", "levenberg_marquardt_while",
           "gauss_newton", "levenberg_marquardt"]


class NLSResult(NamedTuple):
    """Jittable/vmappable nonlinear-LSQ result.

    ``obj_trace`` has fixed length ``max_iters + 1`` (entry 0 is the
    initial objective); entries past ``num_iters`` hold NaN padding.
    """
    params: jnp.ndarray
    obj_val: jnp.ndarray
    obj_trace: jnp.ndarray
    num_iters: jnp.ndarray
    converged: jnp.ndarray


def _qr_lsq(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve min ||A x - b|| via thin QR + back-substitution."""
    Q, R = jnp.linalg.qr(A, mode="reduced")
    return jax.scipy.linalg.solve_triangular(R, Q.T @ b, lower=False)


def _nls_while(propose: Callable, obj: Callable, init_params,
               init_damping, tol: float, max_iters: int) -> NLSResult:
    """Shared while_loop driver.

    ``propose(params, damping) -> (new_params, new_damping)`` is one
    candidate step (GN: damping is the fixed step size; LM: the adaptive
    mu, with accept/reject folded in via ``where``).  Stops when the
    objective change falls to ``tol`` or ``max_iters`` is hit.
    """
    obj0 = obj(init_params)
    trace0 = jnp.full((max_iters + 1,), jnp.nan,
                      dtype=jnp.result_type(obj0, jnp.float32))
    trace0 = trace0.at[0].set(obj0)

    def cond(carry):
        it, _, _, prev_obj, cur_obj, _ = carry
        return (it == 0) | ((it < max_iters)
                            & (jnp.abs(cur_obj - prev_obj) > tol)
                            & jnp.isfinite(cur_obj))

    def body(carry):
        it, params, damping, _, cur_obj, trace = carry
        new_params, new_damping = propose(params, damping)
        new_obj = obj(new_params)
        trace = trace.at[it + 1].set(new_obj)
        return it + 1, new_params, new_damping, cur_obj, new_obj, trace

    it, params, _, prev_obj, cur_obj, trace = jax.lax.while_loop(
        cond, body, (jnp.asarray(0), init_params,
                     jnp.asarray(init_damping, dtype=obj0.dtype),
                     jnp.asarray(jnp.inf, dtype=obj0.dtype), obj0, trace0))
    converged = jnp.isfinite(cur_obj) & (jnp.abs(cur_obj - prev_obj) <= tol)
    return NLSResult(params, cur_obj, trace, it, converged)


def _residual_and_obj(f: Callable, ys, Xi):
    def residual(params):
        return ys - f(params)

    def obj(params):
        r = residual(params)
        return jnp.dot(r, r) / Xi

    return residual, obj


def gauss_newton_while(f: Callable, init_params: jnp.ndarray, ys, Xi,
                       lr: float = 1.0, tol: float = 1e-10,
                       max_iters: int = 100) -> NLSResult:
    """Jittable Gauss--Newton: each step solves the linearized problem
    ``min ||J dx - r||`` by QR and moves ``params + lr * dx``."""
    residual, obj = _residual_and_obj(f, ys, Xi)

    def propose(params, step):
        J = jax.jacfwd(f)(params)
        dx = _qr_lsq(J, residual(params))
        return params + step * dx, step

    return _nls_while(propose, obj, init_params, lr, tol, max_iters)


def levenberg_marquardt_while(f: Callable, init_params: jnp.ndarray, ys,
                              Xi, init_mu: float = 1.0, nu: float = 2.0,
                              tol: float = 1e-10,
                              max_iters: int = 100) -> NLSResult:
    """Jittable Levenberg--Marquardt via the augmented-rows QR form.

    The damped subproblem ``min ||J dx - r||^2 + mu ||S dx||^2`` with
    Marquardt scaling ``S = diag(||J_col||)`` is the plain least-squares
    problem on ``[J; sqrt(mu) S]`` against ``[r; 0]``.  A step that fails
    to reduce the objective is rejected and ``mu`` grows by ``nu``;
    otherwise it shrinks by ``nu``.
    """
    residual, obj = _residual_and_obj(f, ys, Xi)
    p = init_params.shape[-1]

    def propose(params, mu):
        r = residual(params)
        J = jax.jacfwd(f)(params)
        col_scale = jnp.linalg.norm(J, axis=0)
        # Guard zero columns so the augmented block stays full-rank.
        col_scale = jnp.maximum(col_scale, 1e-12)
        A = jnp.concatenate(
            [J, jnp.sqrt(mu) * jnp.diag(col_scale)], axis=0)
        b = jnp.concatenate([r, jnp.zeros((p,), dtype=r.dtype)])
        dx = _qr_lsq(A, b)
        cand = params + dx
        improved = obj(cand) < obj(params)
        new_params = jnp.where(improved, cand, params)
        new_mu = jnp.where(improved, mu / nu, mu * nu)
        return new_params, new_mu

    return _nls_while(propose, obj, init_params, init_mu, tol, max_iters)


def _trim(res: NLSResult) -> Tuple[jnp.ndarray, jnp.ndarray]:
    n = int(res.num_iters) + 1
    return res.params, res.obj_trace[:n]


def gauss_newton(f: Callable, init_params, ys, Xi, lr: float = 1.0,
                 stop_tolerance: float = 1e-10,
                 max_iters: int = 100) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Host-facing wrapper: runs the jitted while_loop Gauss--Newton and
    returns ``(params, objective trajectory)`` (reference API shape)."""
    run = jax.jit(gauss_newton_while,
                  static_argnames=("f", "max_iters"))
    return _trim(run(f, jnp.asarray(init_params), ys, Xi, lr=lr,
                     tol=stop_tolerance, max_iters=max_iters))


def levenberg_marquardt(f: Callable, init_params, ys, Xi, lr: float = 1.0,
                        nu: float = 2.0, stop_tolerance: float = 1e-10,
                        max_iters: int = 100) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Host-facing wrapper: jitted while_loop LM; ``lr`` is the initial
    damping ``mu`` (reference API shape)."""
    run = jax.jit(levenberg_marquardt_while,
                  static_argnames=("f", "max_iters"))
    return _trim(run(f, jnp.asarray(init_params), ys, Xi, init_mu=lr,
                     nu=nu, tol=stop_tolerance, max_iters=max_iters))
