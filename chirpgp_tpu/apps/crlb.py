"""Filter-error Monte-Carlo and posterior Cramer--Rao bound jobs.

Reference: ``tetralith/jobs/crlb_ekf.py`` / ``crlb_ghf.py`` (paper Fig 5):
simulate N trajectories of the chirp SDE at fixed parameters, filter every
measurement sequence, and reduce per-time-step squared errors on the chirp
and V components.  The reference runs N=1e6 on a 20-core/130GB Slurm node;
here the MC axis is vmapped per device and sharded over the mesh, with the
error reduction done by ``psum`` (SURVEY.md 3.4) so N scales with the mesh.
"""

import math
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from chirpgp_tpu.infer import ekf, sgp_filter
from chirpgp_tpu.models import model_chirp, disc_chirp_lcd
from chirpgp_tpu.quad import SigmaPoints, gauss_hermite
from chirpgp_tpu.utils import simulate_sde

__all__ = ["filter_error_mc", "filter_error_mc_chunked",
           "pcrlb_chirp_mc"]


def filter_error_mc(lam: float, b: float, delta: float, ell: float,
                    sigma: float, Xi: float, num_mcs: int,
                    method: str = "ghf", dt: float = 0.01, T: int = 500,
                    gh_order: int = 3, key=None, mesh=None) -> Dict[str, np.ndarray]:
    """Per-time-step mean/std of squared filter errors over ``num_mcs``
    simulated trajectories (reference ``crlb_ekf.py:28-97``; defaults
    dt=0.01, T=500 as in ``crlb_ekf.py:27-28``).

    Returns host arrays ``mean_err_x2``/``std_err_x2`` (chirp component)
    and ``mean_err_v``/``std_err_v`` (frequency state).
    """
    if key is None:
        key = jax.random.PRNGKey(2022)
    _, _, m0, P0, H = model_chirp(lam, b, ell, sigma, delta)
    trans = disc_chirp_lcd(lam, b, ell, sigma)
    sgps = gauss_hermite(d=4, order=gh_order)

    def per_seed(k):
        k_traj, k_noise = jax.random.split(k)
        traj = simulate_sde(trans, m0, P0, dt, T, k_traj)
        ys = traj @ H + math.sqrt(Xi) * jax.random.normal(k_noise, (T,))
        if method == "ghf":
            mfs, _, _ = sgp_filter(trans, sgps, H, Xi, m0, P0, dt, ys)
        elif method == "ekf":
            mfs, _, _ = ekf(trans, H, Xi, m0, P0, dt, ys)
        else:
            raise ValueError(f"Unknown method {method!r}")
        err_x2 = (mfs[:, 1] - traj[:, 1]) ** 2
        err_v = (mfs[:, 2] - traj[:, 2]) ** 2
        return dict(err_x2=err_x2, err_v=err_v,
                    err_x2_sq=err_x2 ** 2, err_v_sq=err_v ** 2)

    keys = jax.random.split(key, num_mcs)
    if mesh is not None:
        from chirpgp_tpu.parallel import sharded_mean
        means = sharded_mean(per_seed, keys, mesh)
    else:
        out = jax.jit(jax.vmap(per_seed))(keys)
        means = jax.tree_util.tree_map(lambda x: jnp.mean(x, axis=0), out)
    means = jax.device_get(means)
    var_x2 = np.maximum(means["err_x2_sq"] - means["err_x2"] ** 2, 0.0)
    var_v = np.maximum(means["err_v_sq"] - means["err_v"] ** 2, 0.0)
    return dict(mean_err_x2=np.asarray(means["err_x2"]),
                std_err_x2=np.sqrt(var_x2),
                mean_err_v=np.asarray(means["err_v"]),
                std_err_v=np.sqrt(var_v))


def _reference_sim_setup(lam, b, delta, ell, sigma, dt, dtype):
    """The reference CRLB jobs' simulation contract
    (``crlb_ekf.py:34-57``): sample x0 ~ N(m0, P0), step the LCD
    conditional MEAN, and add noise with the FIXED factor
    ``chol(cov(0, dt))`` (the conditional covariance evaluated once at
    x = 0), i.e. the simulator is not re-linearized per state."""
    _, _, m0, P0, H = model_chirp(lam, b, ell, sigma, delta)
    trans = disc_chirp_lcd(lam, b, ell, sigma)
    chol_P0 = jnp.linalg.cholesky(P0).astype(dtype)
    _, state_cov = trans(jnp.zeros((4,)), dt)
    chol_Q = jnp.linalg.cholesky(state_cov).astype(dtype)
    return (trans, m0.astype(dtype), P0.astype(dtype), H.astype(dtype),
            chol_P0, chol_Q)


def filter_error_mc_chunked(lam: float, b: float, delta: float, ell: float,
                            sigma: float, Xi: float, num_mcs: int,
                            method: str = "ghf", dt: float = 0.01,
                            T: int = 500, gh_order: int = 3, key=None,
                            chunk: int = 16384, backend: str = "auto",
                            dtype=jnp.float32) -> Dict[str, np.ndarray]:
    """Reference-scale (1e6-trajectory) filter-error Monte Carlo with
    bounded memory: trajectories are simulated, filtered, and reduced to
    per-time-step error sums in chunks of ``chunk`` seeds; sums
    accumulate on the host in float64.

    Simulation follows the reference job's semantics exactly (see
    :func:`_reference_sim_setup`; ref ``tetralith/jobs/crlb_ekf.py:39-64``
    with num_mcs=1e6 at :59), except that measurement noise gets its own
    independent subkey (the reference reuses one key for the state and
    measurement draws).

    ``backend``: "cf" filters each chunk through the channels-first
    square-root batched kernel (``infer.batched``, MC lanes on the last
    axis); "vmap" uses the per-seed covariance filters under
    ``jax.vmap``; "auto" picks "cf" for the sigma-point method and
    "vmap" for the EKF (whose per-step Jacobian has no batched kernel).
    Which backend is faster on the H100 is not measured (ROADMAP D3).

    Returns per-step ``mean_err_x2``/``std_err_x2`` (chirp component
    error^2) and ``mean_err_v``/``std_err_v``.
    """
    if key is None:
        key = jax.random.PRNGKey(666)
    trans, m0, P0, H, chol_P0, chol_Q = _reference_sim_setup(
        lam, b, delta, ell, sigma, dt, dtype)
    sgps = gauss_hermite(d=4, order=gh_order)
    sqrt_Xi = math.sqrt(Xi)
    if backend == "auto":
        backend = "cf" if method == "ghf" else "vmap"

    def sim_seed(k):
        k0, kx, ky = jax.random.split(k, 3)
        x0 = m0 + chol_P0 @ jax.random.normal(k0, (4,), dtype=dtype)
        rnds_x = jax.random.normal(kx, (T, 4), dtype=dtype)
        rnds_y = jax.random.normal(ky, (T,), dtype=dtype)

        def sim_step(x, rnd):
            rx, ry = rnd
            m, _ = trans(x, dt)
            x = m + chol_Q @ rx
            y = jnp.dot(H, x) + sqrt_Xi * ry
            return x, (x, y)

        _, (xs, ys) = jax.lax.scan(sim_step, x0, (rnds_x, rnds_y))
        return xs, ys

    def per_seed(k):
        xs, ys = sim_seed(k)
        if method == "ghf":
            mfs, _, _ = sgp_filter(trans, sgps, H, Xi, m0, P0, dt, ys)
        elif method == "ekf":
            mfs, _, _ = ekf(trans, H, Xi, m0, P0, dt, ys)
        else:
            raise ValueError(f"Unknown method {method!r}")
        err_x2 = (mfs[:, 1] - xs[:, 1]) ** 2
        err_v = (mfs[:, 2] - xs[:, 2]) ** 2
        return err_x2, err_v

    if backend == "cf":
        if method != "ghf":
            raise ValueError("backend='cf' supports the sigma-point "
                             "filter only")
        from chirpgp_tpu.infer.batched import sqrt_sgp_filter_batched

        @jax.jit
        def chunk_stats(ks):
            xs, ys = jax.vmap(sim_seed)(ks)      # (C, T, 4), (C, T)
            mfs, _, _ = sqrt_sgp_filter_batched(
                trans, sgps, H, Xi, m0, P0, dt, ys)   # mfs (T, d, C)
            ex2 = (mfs[:, 1, :].T - xs[:, :, 1]) ** 2     # (C, T)
            ev = (mfs[:, 2, :].T - xs[:, :, 2]) ** 2
            return (ex2.sum(0), (ex2 ** 2).sum(0),
                    ev.sum(0), (ev ** 2).sum(0))
    else:
        @jax.jit
        def chunk_stats(ks):
            ex2, ev = jax.vmap(per_seed)(ks)        # (C, T)
            return (ex2.sum(0), (ex2 ** 2).sum(0),
                    ev.sum(0), (ev ** 2).sum(0))

    s_x2 = np.zeros((T,), np.float64)
    s_x2_sq = np.zeros((T,), np.float64)
    s_v = np.zeros((T,), np.float64)
    s_v_sq = np.zeros((T,), np.float64)
    done = 0
    while done < num_mcs:
        n = min(chunk, num_mcs - done)
        ks = jax.random.fold_in(key, done // chunk)
        ks = jax.random.split(ks, n)
        a, b_, c, e = jax.device_get(chunk_stats(ks))
        s_x2 += np.asarray(a, np.float64)
        s_x2_sq += np.asarray(b_, np.float64)
        s_v += np.asarray(c, np.float64)
        s_v_sq += np.asarray(e, np.float64)
        done += n

    mean_x2 = s_x2 / num_mcs
    mean_v = s_v / num_mcs
    var_x2 = np.maximum(s_x2_sq / num_mcs - mean_x2 ** 2, 0.0)
    var_v = np.maximum(s_v_sq / num_mcs - mean_v ** 2, 0.0)
    return dict(mean_err_x2=mean_x2, std_err_x2=np.sqrt(var_x2),
                mean_err_v=mean_v, std_err_v=np.sqrt(var_v))


def pcrlb_chirp_mc(lam: float, b: float, delta: float, ell: float,
                   sigma: float, Xi: float, num_mcs: int = 100_000,
                   dt: float = 0.01, T: int = 500, key=None,
                   dtype=jnp.float32) -> Dict[str, np.ndarray]:
    """Posterior Cramer--Rao bound for the chirp model on simulated
    trajectories (the reference sweep's missing ``crlb_model`` job --
    ``run_crlbs.sh:4`` submits it but no such file ships; the recursion
    itself is ``chirpgp/models.py:583``).

    Returns per-step ``pcrlb_x2``/``pcrlb_v``: the (1,1) and (2,2)
    entries of J_k^{-1}, the bound on the mean squared filter error of
    the chirp and V components.
    """
    from chirpgp_tpu.models.crlb import posterior_cramer_rao

    if key is None:
        key = jax.random.PRNGKey(666)
    trans, m0, P0, H, chol_P0, chol_Q = _reference_sim_setup(
        lam, b, delta, ell, sigma, dt, dtype)
    sqrt_Xi = math.sqrt(Xi)
    Q = chol_Q @ chol_Q.T

    def sim(k):
        k0, kx, ky = jax.random.split(k, 3)
        x0 = m0 + chol_P0 @ jax.random.normal(k0, (4,), dtype=dtype)
        rnds_x = jax.random.normal(kx, (T, 4), dtype=dtype)
        rnds_y = jax.random.normal(ky, (T,), dtype=dtype)

        def step(x, rnd):
            rx, ry = rnd
            m, _ = trans(x, dt)
            x = m + chol_Q @ rx
            y = jnp.dot(H, x) + sqrt_Xi * ry
            return x, (x, y)

        _, (xs, ys) = jax.lax.scan(step, x0, (rnds_x, rnds_y))
        return jnp.concatenate([x0[None], xs], axis=0), ys

    xss, yss = jax.jit(jax.vmap(sim))(jax.random.split(key, num_mcs))
    xss = jnp.swapaxes(xss, 0, 1)          # (T+1, N, d)
    yss = jnp.swapaxes(yss, 0, 1)          # (T, N)

    def logpdf_transition(xt, xs):
        m, _ = trans(xs, dt)
        return jax.scipy.stats.multivariate_normal.logpdf(xt, m, Q)

    def logpdf_likelihood(y, x):
        return jax.scipy.stats.norm.logpdf(y, jnp.dot(H, x), sqrt_Xi)

    j0 = jnp.linalg.inv(P0)
    js = posterior_cramer_rao(xss, yss, j0, logpdf_transition,
                              logpdf_likelihood)
    inv = jax.vmap(jnp.linalg.inv)(js)
    return dict(pcrlb_x2=np.asarray(inv[:, 1, 1]),
                pcrlb_v=np.asarray(inv[:, 2, 2]))
