"""End-to-end IF-estimation pipelines with a single typed config.

The reference scatters the experiment contract across per-script module
constants (``demos/*.py``, ``tetralith/jobs/*.py``); here one
:class:`IFEstimationConfig` captures model choice, discretization,
quadrature, measurement noise, and optimizer, and drives jittable
functions:

``nll_fn`` (theta -> filter NLL) -> :func:`fit_mle` -> :func:`estimate_if`
(filter + smooth + Gaussian expectation of g(V)).

Canonical flow parity: ``demos/ghfs_mle.py:49-93``.
"""

import dataclasses
import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from chirpgp_tpu.fit.mle import lbfgs_minimize, scipy_minimize, MLEResult
from chirpgp_tpu.infer import (
    ekf, eks, sgp_filter, sgp_smoother, cd_ekf, cd_eks,
    cd_sgp_filter, cd_sgp_smoother,
    sqrt_ekf, sqrt_eks, sqrt_sgp_filter, sqrt_sgp_smoother)
from chirpgp_tpu.models import (
    g, g_inv, build_chirp_model, build_harmonic_chirp_model,
    build_lascala_model)
from chirpgp_tpu.quad import (
    SigmaPoints, cubature, gauss_hermite, unscented, gaussian_expectation_1d)

__all__ = ["IFEstimationConfig", "make_nll_fn", "fit_mle", "estimate_if",
           "run_pipeline"]


@dataclasses.dataclass(frozen=True)
class IFEstimationConfig:
    """Experiment contract for one IF-estimation run.

    Defaults reproduce the reference's canonical toymodel setup
    (``demos/ghfs_mle.py:20-49``): dt=1e-3, Xi=0.1, GH order 3,
    init theta = g^{-1}([0.1, 0.1, 0.1, 1, 1, 7]).
    """

    dt: float = 1e-3
    Xi: float = 0.1
    method: str = "ghfs"          # ghfs | ekfs | cd_ghfs | cd_ekfs
    model: str = "chirp"          # chirp | harmonic | lascala
    num_harmonics: int = 1
    freq_scale: float = 1.0
    quadrature: str = "gauss_hermite"   # gauss_hermite | cubature | unscented
    gh_order: int = 3
    # scipy is the single-seed default: it matches the reference's
    # optimizer contract (jaxopt.ScipyMinimize L-BFGS-B, one jitted
    # value-and-grad dispatch per iteration).  It was made the default
    # because a monolithic minutes-long while_loop dispatch failed on the
    # first backend; whether the in-JAX "lbfgs" should replace it on the
    # H100 is ROADMAP D4.  Batched/sharded sweeps use the in-JAX "lbfgs"
    # so the whole MLE jits into one program.
    optimizer: str = "scipy"      # scipy (host L-BFGS-B) | lbfgs (in-JAX)
    max_iters: int = 200
    chunk_iters: int = 0          # >0: host-chunked L-BFGS dispatches
    # Stall-freeze rule of the stepped batched L-BFGS (see
    # fit.mle.lbfgs_minimize_stepped).  Defaults match scipy L-BFGS-B's
    # ftol (~2.2e-9) with patient stalling: the looser (1e-6, 3) rule
    # froze hard OU-magnitude seeds on plateaus near the init that the
    # reference's scipy runs escape (paired-seed diagnosis, round 2),
    # e.g. seed 98 random: rmse x10 67.0 loose vs 7.4 tight vs 7.5
    # reference.
    ftol_rel: float = 1e-9
    stall_patience: int = 10
    expectation_order: int = 10   # GH order for E[g(V)]
    form: str = "cov"             # cov | sqrt (float32-safe QR forms; ghfs/ekfs only)
    # lax.scan unroll for the filter recursions: the per-step bodies are
    # tiny (d<=12 algebra), so executing several steps per loop iteration
    # amortizes scan overhead at zero numerical cost (bit-identical
    # output; the gain is not measured on the H100).  Default 1:
    # unrolling multiplies reverse-mode residual memory per loop
    # iteration (a B=300 x T=3141 batched gradient sweep at unroll=4
    # asked for 25.7 GB); whether 80 GB lifts that limit is ROADMAP S2.
    # Safe to raise for single-record estimation or forward-only runs.
    scan_unroll: int = 1

    # ---- derived helpers ----

    def state_dim(self) -> int:
        return 2 * self.num_harmonics + 2 if self.model == "harmonic" else 4

    def sigma_points(self) -> SigmaPoints:
        d = self.state_dim()
        if self.quadrature == "gauss_hermite":
            return gauss_hermite(d, order=self.gh_order)
        if self.quadrature == "cubature":
            return cubature(d)
        if self.quadrature == "unscented":
            return unscented(d)
        raise ValueError(f"Unknown quadrature {self.quadrature!r}")

    def build(self, params):
        if self.model == "chirp":
            return build_chirp_model(params)
        if self.model == "harmonic":
            return build_harmonic_chirp_model(
                params, num_harmonics=self.num_harmonics,
                freq_scale=self.freq_scale)
        if self.model == "lascala":
            return build_lascala_model(params)
        raise ValueError(f"Unknown model {self.model!r}")

    def default_init_theta(self) -> jnp.ndarray:
        if self.model == "lascala":
            return g_inv(jnp.array([0.1, 1.0, 1.0, 7.0]))
        return g_inv(jnp.array([0.1, 0.1, 0.1, 1.0, 1.0, 7.0]))


def _filter_fns(cfg: IFEstimationConfig):
    """Return (filter, smoother) closures ``(pack, ys) -> ...`` for the
    configured method.  In sqrt form the second moment returned is a
    Cholesky factor, not a covariance."""
    sgps = cfg.sigma_points() if cfg.method in ("ghfs", "cd_ghfs") else None

    if cfg.form == "sqrt":
        if cfg.method == "ghfs":
            def flt(pack, ys):
                return sqrt_sgp_filter(pack.m_and_cov, sgps, pack.H, cfg.Xi,
                                       pack.m0, pack.P0, cfg.dt, ys,
                                       unroll=cfg.scan_unroll)

            def smt(pack, mfs, Lfs):
                return sqrt_sgp_smoother(pack.m_and_cov, sgps, mfs, Lfs,
                                         cfg.dt)
        elif cfg.method == "ekfs":
            def flt(pack, ys):
                return sqrt_ekf(pack.m_and_cov, pack.H, cfg.Xi, pack.m0,
                                pack.P0, cfg.dt, ys,
                                unroll=cfg.scan_unroll)

            def smt(pack, mfs, Lfs):
                return sqrt_eks(pack.m_and_cov, mfs, Lfs, cfg.dt)
        else:
            raise ValueError(
                f"form='sqrt' supports methods ghfs/ekfs, got {cfg.method!r}")
        return flt, smt

    if cfg.method == "ghfs":
        def flt(pack, ys):
            return sgp_filter(pack.m_and_cov, sgps, pack.H, cfg.Xi,
                              pack.m0, pack.P0, cfg.dt, ys)

        def smt(pack, mfs, Pfs):
            return sgp_smoother(pack.m_and_cov, sgps, mfs, Pfs, cfg.dt)
    elif cfg.method == "ekfs":
        def flt(pack, ys):
            return ekf(pack.m_and_cov, pack.H, cfg.Xi, pack.m0, pack.P0,
                       cfg.dt, ys)

        def smt(pack, mfs, Pfs):
            return eks(pack.m_and_cov, mfs, Pfs, cfg.dt)
    elif cfg.method == "cd_ghfs":
        def flt(pack, ys):
            b = pack.dispersion(pack.m0)
            # remat: reverse-mode through the RK4 sigma-point scan at
            # T~3k otherwise keeps every step's RK4 stages (17.3 GB for
            # B=300); not re-measured against the H100's 80 GB.
            return cd_sgp_filter(pack.drift, b, sgps, pack.H, cfg.Xi,
                                 pack.m0, pack.P0, cfg.dt, ys, remat=True,
                                 unroll=cfg.scan_unroll)

        def smt(pack, mfs, Pfs):
            b = pack.dispersion(pack.m0)
            return cd_sgp_smoother(pack.drift, b, sgps, mfs, Pfs, cfg.dt)
    elif cfg.method == "cd_ekfs":
        def flt(pack, ys):
            return cd_ekf(pack.drift, pack.dispersion, pack.H, cfg.Xi,
                          pack.m0, pack.P0, cfg.dt, ys, remat=True,
                          unroll=cfg.scan_unroll)

        def smt(pack, mfs, Pfs):
            return cd_eks(pack.drift, pack.dispersion, mfs, Pfs, cfg.dt)
    else:
        raise ValueError(f"Unknown method {cfg.method!r}")
    return flt, smt


def make_nll_fn(cfg: IFEstimationConfig, ys: jnp.ndarray) -> Callable:
    """The MLE objective: softplus-reparametrized params -> filter NLL
    (reference ``demos/ghfs_mle.py:53-56``)."""
    flt, _ = _filter_fns(cfg)

    def nll(theta):
        pack = cfg.build(g(theta))
        return flt(pack, ys)[2][-1]

    return nll


def fit_mle(cfg: IFEstimationConfig, ys: jnp.ndarray,
            init_theta: Optional[jnp.ndarray] = None) -> MLEResult:
    """Maximize the filter-marginal likelihood.  Returns the result in
    theta (unconstrained) space."""
    if init_theta is None:
        init_theta = cfg.default_init_theta()
    nll = make_nll_fn(cfg, ys)
    if cfg.optimizer == "lbfgs":
        return lbfgs_minimize(nll, init_theta, max_iters=cfg.max_iters,
                              chunk_iters=cfg.chunk_iters or None)
    return scipy_minimize(nll, init_theta,
                          options={"maxiter": cfg.max_iters})


def estimate_if(cfg: IFEstimationConfig, params: jnp.ndarray,
                ys: jnp.ndarray):
    """Filter + smooth at fixed (constrained) params and push the V
    posterior through g.  Jittable.

    Returns dict with filtering/smoothing moments, the IF posterior mean
    ``E[g(V_t)]`` (order-10 GH) and the 95% band endpoints mapped through g
    (reference ``demos/ghfs_mle.py:84-101``).
    """
    flt, smt = _filter_fns(cfg)
    pack = cfg.build(params)
    mfs, Pfs, nell = flt(pack, ys)
    mss, Pss = smt(pack, mfs, Pfs)
    v_idx = -2 if cfg.model == "harmonic" else 2
    v_mean = mss[:, v_idx]
    if cfg.form == "sqrt":
        # Second moments are Cholesky factors: var = ||row_v(L)||^2.
        v_std = jnp.linalg.norm(Pss[:, v_idx, :], axis=-1)
        Pfs = Pfs @ jnp.swapaxes(Pfs, -1, -2)
        Pss = Pss @ jnp.swapaxes(Pss, -1, -2)
    else:
        v_std = jnp.sqrt(jnp.maximum(Pss[:, v_idx, v_idx], 0.0))
    if_mean = gaussian_expectation_1d(v_mean, v_std,
                                      order=cfg.expectation_order)
    if_mean = if_mean * cfg.freq_scale
    lo = g(v_mean - 1.96 * v_std) * cfg.freq_scale
    hi = g(v_mean + 1.96 * v_std) * cfg.freq_scale
    return dict(mfs=mfs, Pfs=Pfs, nell=nell, mss=mss, Pss=Pss,
                if_mean=if_mean, if_lower=lo, if_upper=hi)


def estimate_if_batched(cfg: IFEstimationConfig, params: jnp.ndarray,
                        yss: jnp.ndarray):
    """High-throughput fixed-params estimation over a batch of sequences
    ``yss`` (B, T) using the channels-first batched kernels (the MC batch
    on the last axis; its speed against vmapping :func:`estimate_if` is
    not measured on the H100).  Requires ``method='ghfs'`` semantics
    (sqrt sigma-point filter+smoother) and a one-hot measurement vector.
    ``cfg.scan_unroll`` is forwarded to the filter scan.

    Returns dict with ``if_mean`` (B, T) and ``nell`` (B,).
    """
    from chirpgp_tpu.infer.batched import (
        sqrt_sgp_filter_batched, sqrt_sgp_smoother_batched,
        gaussian_expectation_batched)

    pack = cfg.build(params)
    sgps = cfg.sigma_points()
    mfs, Lfs, nll = sqrt_sgp_filter_batched(
        pack.m_and_cov, sgps, pack.H, cfg.Xi, pack.m0, pack.P0, cfg.dt,
        yss, unroll=cfg.scan_unroll)
    mss, Lss = sqrt_sgp_smoother_batched(pack.m_and_cov, sgps, mfs, Lfs,
                                         cfg.dt)
    v_idx = (mss.shape[1] - 2) if cfg.model == "harmonic" else 2
    v_mean = mss[:, v_idx, :]
    v_std = jnp.sqrt(jnp.einsum("tkb,tkb->tb", Lss[:, v_idx],
                                Lss[:, v_idx]))
    if_mean = gaussian_expectation_batched(
        v_mean, v_std, order=cfg.expectation_order) * cfg.freq_scale
    return dict(if_mean=if_mean.T, nell=nll[-1], mss=mss, Lss=Lss)


def run_pipeline(cfg: IFEstimationConfig, ys: jnp.ndarray,
                 init_theta: Optional[jnp.ndarray] = None):
    """MLE then estimation; returns (opt_result, constrained params,
    estimate dict).  Divergent optimizations (success=False) still return
    the estimate at the last iterate, mirroring the reference's
    NaN-recording contract upstream."""
    opt = fit_mle(cfg, ys, init_theta)
    params = g(opt.params)
    est = estimate_if(cfg, params, ys)
    return opt, params, est
