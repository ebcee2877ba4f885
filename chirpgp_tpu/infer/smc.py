"""Bootstrap particle filter (sequential Monte Carlo) for the chirp SSMs.

A BASELINE.json addition over the reference (which has only Gaussian
filters): particle alternatives to EKF/SGP with an unbiased marginal-
likelihood estimate, for posterior checks and for the sharded NUTS/SMC
scale-out path.

Design: N particles live on-chip as a (N, d) batch; propagation samples
the model's conditional discretization (the same ``Transition`` objects
the Gaussian filters use), weighting is the 1-D Gaussian measurement
likelihood, and resampling is systematic (a sorted-uniform gather --
O(N log N) but fully on-device and differentiable-free).  ``vmap`` over
seeds and ``shard_map`` over a mesh compose on top exactly as for the
Gaussian filters.

:func:`bootstrap_filter_sharded` shards the PARTICLE axis over a device
mesh: weights/ESS/log-ML reductions are ``psum`` collectives and the
systematic resampling step is exact and global -- particles and
log-weights are ``all_gather``-ed (the global permutation SURVEY §7
flags as the hard part of distributed SMC), resampled with one shared
uniform, and each shard keeps its slice of the result.  For the d<=16
state dims of this model family the gather is a few KB per step.
"""

import math
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from chirpgp_tpu.models.transitions import Transition, as_transition

__all__ = ["bootstrap_filter", "bootstrap_filter_sharded",
           "systematic_resample", "effective_sample_size"]


def systematic_resample(key, log_weights: jnp.ndarray) -> jnp.ndarray:
    """Systematic resampling: returns indices of shape (N,).

    Positions ``(i + u) / N`` with one shared uniform ``u`` are inverted
    through the weight CDF via ``searchsorted``.
    """
    n = log_weights.shape[0]
    w = jax.nn.softmax(log_weights)
    cdf = jnp.cumsum(w)
    u = jax.random.uniform(key, ())
    positions = (jnp.arange(n) + u) / n
    return jnp.clip(jnp.searchsorted(cdf, positions), 0, n - 1)


def effective_sample_size(log_weights: jnp.ndarray) -> jnp.ndarray:
    """ESS = 1 / sum(w_i^2) of normalized weights."""
    w = jax.nn.softmax(log_weights)
    return 1.0 / jnp.sum(w ** 2)


class SMCResult(NamedTuple):
    means: jnp.ndarray        # (T, d) weighted filtering means
    log_ml: jnp.ndarray       # (T,) cumulative log marginal likelihood
    ess: jnp.ndarray          # (T,) effective sample size before resampling


def bootstrap_filter(cond_m_cov, H: jnp.ndarray, Xi, m0: jnp.ndarray,
                     P0: jnp.ndarray, dt, ys: jnp.ndarray, key,
                     num_particles: int = 1024,
                     ess_threshold: float = 0.5) -> SMCResult:
    """Bootstrap particle filter with adaptive systematic resampling.

    Parameters mirror :func:`chirpgp_tpu.infer.filters.sgp_filter`; the
    transition is *sampled* instead of moment-matched.  Returns weighted
    filtering means, the cumulative log-marginal-likelihood (the SMC
    analog of ``-nll``), and the pre-resampling ESS trace.
    """
    trans = as_transition(cond_m_cov)
    if not trans.const_cov:
        raise NotImplementedError(
            "bootstrap_filter currently requires a state-independent "
            "transition covariance (true for the chirp family).")
    d = m0.shape[-1]
    N = num_particles
    dtype = m0.dtype

    Lq = jnp.linalg.cholesky(trans.cov_const(dt)).astype(dtype)
    L0 = jnp.linalg.cholesky(P0).astype(dtype)
    log_xi_norm = -0.5 * math.log(2.0 * math.pi) \
        - 0.5 * jnp.log(jnp.asarray(Xi, dtype))

    key, sub = jax.random.split(key)
    particles = m0 + jax.random.normal(sub, (N, d), dtype) @ L0.T
    log_w = jnp.zeros((N,), dtype)

    def step(carry, inp):
        particles, log_w, log_ml = carry
        y, k = inp
        k_prop, k_res = jax.random.split(k)

        # Propagate through the conditional law (batched mean + shared Lq).
        mean = trans.mean(particles, dt)                       # (N, d)
        noise = jax.random.normal(k_prop, (N, d), dtype) @ Lq.T
        particles = mean + noise

        # Weight by the measurement likelihood.
        pred = particles @ H
        log_like = log_xi_norm - 0.5 * (y - pred) ** 2 / Xi
        log_w_new = log_w + log_like

        # Log-marginal-likelihood increment (normalized-weights form).
        lse_new = jax.scipy.special.logsumexp(log_w_new)
        lse_old = jax.scipy.special.logsumexp(log_w)
        log_ml = log_ml + lse_new - lse_old

        ess = effective_sample_size(log_w_new)
        w_norm = jax.nn.softmax(log_w_new)
        mean_est = w_norm @ particles

        # Adaptive resampling (branchless: gather either resampled or
        # identity indices).
        do_resample = ess < ess_threshold * N
        idx_res = systematic_resample(k_res, log_w_new)
        idx = jnp.where(do_resample, idx_res, jnp.arange(N))
        particles = particles[idx]
        log_w = jnp.where(do_resample, jnp.zeros_like(log_w_new), log_w_new)

        return (particles, log_w, log_ml), (mean_est, log_ml, ess)

    T = ys.shape[0]
    keys = jax.random.split(key, T)
    init = (particles, log_w, jnp.zeros((), dtype))
    _, (means, log_mls, esss) = jax.lax.scan(step, init, (ys, keys))
    return SMCResult(means=means, log_ml=log_mls, ess=esss)


def bootstrap_filter_sharded(cond_m_cov, H: jnp.ndarray, Xi,
                             m0: jnp.ndarray, P0: jnp.ndarray, dt,
                             ys: jnp.ndarray, key, mesh,
                             num_particles: int = 1024,
                             ess_threshold: float = 0.5,
                             axis: str = None) -> SMCResult:
    """:func:`bootstrap_filter` with the particle axis sharded over
    ``mesh``'s first axis.

    Same algorithm, distributed: per-shard propagation/weighting, exact
    global weight normalization + ESS + log-ML via ``psum`` (with a
    ``pmax`` shift for a stable distributed logsumexp), and exact GLOBAL
    systematic resampling -- log-weights and particles are all-gathered,
    inverted through the global CDF with one shared uniform, and each
    shard keeps its own slice of the resampled set.  ``num_particles``
    must divide evenly by the mesh axis size.
    """
    axis = axis or mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    if num_particles % n_dev:
        raise ValueError(f"num_particles={num_particles} must be a "
                         f"multiple of the mesh axis size {n_dev}")
    n_loc = num_particles // n_dev

    trans = as_transition(cond_m_cov)
    if not trans.const_cov:
        raise NotImplementedError(
            "bootstrap_filter_sharded requires a state-independent "
            "transition covariance (true for the chirp family).")
    d = m0.shape[-1]
    N = num_particles
    dtype = m0.dtype

    Lq = jnp.linalg.cholesky(trans.cov_const(dt)).astype(dtype)
    L0 = jnp.linalg.cholesky(P0).astype(dtype)
    log_xi_norm = -0.5 * math.log(2.0 * math.pi) \
        - 0.5 * jnp.log(jnp.asarray(Xi, dtype))
    T = ys.shape[0]
    key_init, key_scan = jax.random.split(key)
    step_keys = jax.random.split(key_scan, T)

    def _global_lse(log_w_loc):
        """Distributed logsumexp over the sharded particle axis."""
        m = jax.lax.pmax(jnp.max(log_w_loc), axis)
        s = jax.lax.psum(jnp.sum(jnp.exp(log_w_loc - m)), axis)
        return m + jnp.log(s)

    from jax.sharding import PartitionSpec as P

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P()), out_specs=(P(), P(), P()),
             check_vma=False)
    def run(ys_rep, keys_rep):
        shard = jax.lax.axis_index(axis)
        # Per-shard slice of the initial particle cloud: an independent
        # stream per shard via fold_in keeps generation local.
        k0 = jax.random.fold_in(key_init, shard)
        particles = m0 + jax.random.normal(k0, (n_loc, d), dtype) @ L0.T
        log_w = jnp.zeros((n_loc,), dtype)

        def step(carry, inp):
            particles, log_w, log_ml = carry
            y, k = inp
            k_prop, k_res = jax.random.split(k)
            k_prop = jax.random.fold_in(k_prop, shard)

            mean = trans.mean(particles, dt)
            noise = jax.random.normal(k_prop, (n_loc, d), dtype) @ Lq.T
            particles = mean + noise

            pred = particles @ H
            log_like = log_xi_norm - 0.5 * (y - pred) ** 2 / Xi
            log_w_new = log_w + log_like

            lse_new = _global_lse(log_w_new)
            lse_old = _global_lse(log_w)
            log_ml = log_ml + lse_new - lse_old

            w_norm = jnp.exp(log_w_new - lse_new)          # global norm
            ess = 1.0 / jax.lax.psum(jnp.sum(w_norm ** 2), axis)
            mean_est = jax.lax.psum(w_norm @ particles, axis)

            # Exact global systematic resampling: gather the full cloud,
            # invert the global CDF with ONE shared uniform (k_res is
            # replicated), keep this shard's slice.
            all_lw = jax.lax.all_gather(log_w_new, axis).reshape(N)
            all_p = jax.lax.all_gather(particles, axis).reshape(N, d)
            idx = systematic_resample(k_res, all_lw)
            idx_loc = jax.lax.dynamic_slice_in_dim(idx, shard * n_loc,
                                                   n_loc)
            do_resample = ess < ess_threshold * N
            particles = jnp.where(do_resample, all_p[idx_loc], particles)
            log_w = jnp.where(do_resample, jnp.zeros_like(log_w_new),
                              log_w_new)
            return (particles, log_w, log_ml), (mean_est, log_ml, ess)

        init = (particles, log_w, jnp.zeros((), dtype))
        _, (means, log_mls, esss) = jax.lax.scan(
            step, init, (ys_rep, keys_rep))
        return means, log_mls, esss

    means, log_mls, esss = jax.jit(run)(ys, step_keys)
    return SMCResult(means=means, log_ml=log_mls, ess=esss)
