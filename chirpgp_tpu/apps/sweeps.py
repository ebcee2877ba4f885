"""Monte-Carlo experiment sweeps: the RMSE-table and CRLB jobs.

Reproduces the reference's tetralith experiment contract
(``tetralith/jobs/*_mle.py``) on an accelerator:

- **Pregenerated-key pairing**: 1000 keys from ``PRNGKey(999)``
  (``tetralith/generate_rndkeys.py:8-12``) so every method sees the same
  measurement realizations -- the basis of the paper's paired Table I.
- **NaN-on-divergence**: runs whose optimizer fails are recorded as NaN
  rather than crashing the sweep (``tetralith/jobs/ghfs_mle.py:78-81``).
- **Scale-out**: instead of a sequential Python loop per seed
  (``jobs/ghfs_mle.py:61``), seeds are vmapped per device and sharded over
  the mesh with ``shard_map`` -- same program from 1 device to many.
- **Idempotent .npz results** per (method, magnitude) with
  ``rmses`` + learnt params, consumed by :func:`print_rmse_table`.
"""

import json
import math
import os
from functools import partial
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from chirpgp_tpu.apps.pipeline import IFEstimationConfig, make_nll_fn, _filter_fns
from chirpgp_tpu.fit.mle import lbfgs_minimize, lbfgs_minimize_stepped
from chirpgp_tpu.models import g
from chirpgp_tpu.quad import gaussian_expectation_1d
from chirpgp_tpu.toymodels import (
    gen_chirp, gen_harmonic_chirp, constant_mag, damped_exp_mag,
    random_ou_mag, meow_freq)
from chirpgp_tpu.utils import rmse

__all__ = ["generate_rnd_keys", "toymodel_measurements", "mc_mle_sweep",
           "mc_mle_sweep_stepped", "mle_sweep_on_measurements",
           "print_rmse_table", "MAGNITUDES"]


def generate_rnd_keys(num: int = 1000, seed: int = 999) -> jnp.ndarray:
    """The reference's pregenerated random keys
    (``tetralith/generate_rndkeys.py:8-12``)."""
    return jax.random.split(jax.random.PRNGKey(seed), num)


# The three magnitude scenarios of the paper's Table I
# (``demos/ghfs_mle.py:37-39``).
MAGNITUDES = ("const", "damped", "random")


def _magnitude(name: str, key):
    if name == "const":
        return constant_mag(1.0)
    if name == "damped":
        return damped_exp_mag(0.3)
    if name == "random":
        return random_ou_mag(1.0, 1.0, key)
    raise ValueError(f"Unknown magnitude {name!r}")


def toymodel_measurements(key, mag_name: str, dt: float = 1e-3,
                          T: int = 3141, Xi: float = 0.1,
                          num_harmonics: int = 1):
    """One seed's toymodel data: (ts, true_freqs, ys).

    Mirrors the job setup of ``tetralith/jobs/ghfs_mle.py:26-47``: times
    ``dt..T*dt``, meow IF with offset 8, chirp + N(0, Xi) noise.  Each key
    is split exactly once: first for the measurement noise, second for the
    OU magnitude (when used).
    """
    ts = jnp.linspace(dt, dt * T, T)
    freq_func, phase_func = meow_freq(offset=8.0)
    key_noise, key_mag = jax.random.split(key)
    mag = _magnitude(mag_name, key_mag)
    if num_harmonics == 1:
        chirp = gen_chirp(ts, mag, phase_func)
    else:
        # Reference harmonic jobs give EVERY overtone the same magnitude
        # function (``tetralith/jobs/harmonic_ckfs_mle.py:37``:
        # ``gen_harmonic_chirp(ts, [mag] * num_harmonics, ...)``).
        chirp = gen_harmonic_chirp(ts, [mag] * num_harmonics, phase_func)
    ys = chirp + math.sqrt(Xi) * jax.random.normal(key_noise, (T,))
    return ts, freq_func(ts), ys


def mc_mle_sweep(cfg: IFEstimationConfig, keys: jnp.ndarray, mag_name: str,
                 T: int = 3141, mesh=None,
                 init_theta: Optional[jnp.ndarray] = None) -> Dict[str, np.ndarray]:
    """Run MLE + filter + smooth + IF-RMSE for every seed, sharded over
    the mesh.  Returns host arrays: rmses (N,), learnt params (N, P),
    success flags (N,).

    Divergent runs contribute NaN rmse (reference semantics).
    """
    if init_theta is None:
        init_theta = cfg.default_init_theta()
    flt, smt = _filter_fns(cfg)
    v_idx = -2 if cfg.model == "harmonic" else 2

    def per_seed(key):
        ts, true_freqs, ys = toymodel_measurements(
            key, mag_name, dt=cfg.dt, T=T, Xi=cfg.Xi,
            num_harmonics=cfg.num_harmonics if cfg.model == "harmonic" else 1)
        nll = make_nll_fn(cfg, ys)
        opt = lbfgs_minimize(nll, init_theta, max_iters=cfg.max_iters,
                             jit=False)
        params = g(opt.params)
        pack = cfg.build(params)
        mfs, Pfs, _ = flt(pack, ys)
        mss, Pss = smt(pack, mfs, Pfs)
        v_mean = mss[:, v_idx]
        if cfg.form == "sqrt":
            v_std = jnp.linalg.norm(Pss[:, v_idx, :], axis=-1)
        else:
            v_std = jnp.sqrt(jnp.maximum(Pss[:, v_idx, v_idx], 0.0))
        if_mean = gaussian_expectation_1d(
            v_mean, v_std, order=cfg.expectation_order) * cfg.freq_scale
        err = rmse(true_freqs, if_mean)
        err = jnp.where(opt.success, err, jnp.nan)
        return dict(rmse=err, params=params, success=opt.success)

    if mesh is not None:
        from chirpgp_tpu.parallel import sharded_seed_sweep
        out = sharded_seed_sweep(per_seed, keys, mesh)
    else:
        out = jax.jit(jax.vmap(per_seed))(keys)
    return {k: np.asarray(v) for k, v in jax.device_get(out).items()}


def mc_mle_sweep_stepped(cfg: IFEstimationConfig, keys: jnp.ndarray,
                         mag_name: str, T: int = 3141,
                         init_theta: Optional[jnp.ndarray] = None,
                         verbose: bool = False) -> Dict[str, np.ndarray]:
    """:func:`mc_mle_sweep` with the batched L-BFGS advanced one iteration
    per device dispatch (:func:`chirpgp_tpu.fit.mle.lbfgs_minimize_stepped`)
    instead of one monolithic while_loop, so no single XLA program runs for
    minutes (needed on the first backend; not re-established on the H100,
    ROADMAP D4).  Same per-seed math and NaN-on-divergence semantics.
    """
    nh = cfg.num_harmonics if cfg.model == "harmonic" else 1
    gen = partial(toymodel_measurements, mag_name=mag_name, dt=cfg.dt,
                  T=T, Xi=cfg.Xi, num_harmonics=nh)
    ts, true_freqs, ys = jax.jit(jax.vmap(gen))(keys)
    return mle_sweep_on_measurements(cfg, true_freqs, ys,
                                     init_theta=init_theta, verbose=verbose)


def _rescue_stuck_lanes(nll, init_theta, theta0, ys, opt,
                        max_iters: int = 300, rescue_tol: float = 1e-3,
                        outlier_z: float = 8.0,
                        verbose: bool = False):
    """Per-lane SciPy L-BFGS-B fallback for lanes the lockstep batched
    L-BFGS never moved off the init, or that landed far above the
    batch-typical optimum.

    On hard seeds (observed: ~15% of the OU-magnitude draws) the zoom
    line search can fail on the very first iterations, after which the
    stall freeze retires the lane at the init point; the identical f32
    objective then optimizes fine under the host-driven SciPy L-BFGS-B
    (verified seed-for-seed against the reference's f64 optima).  A lane
    is "stuck" when its final NLL is not at least
    ``rescue_tol * max(1, |f_init|)`` below the init NLL (real MLE runs
    on this family improve the NLL by hundreds of nats) or went
    non-finite.  Additionally, a lane whose NLL *improvement*
    (f_final - f_init, negative = good) is a robust outlier above the
    batch median by more than ``outlier_z`` MAD-sigmas is re-optimized:
    those lanes converged to a catastrophically bad local optimum that
    the reference's SciPy path escapes (observed on the KPT model).
    The rescued lane keeps whichever result is better.
    """
    from scipy.optimize import minimize

    f_init = np.asarray(jax.device_get(jax.jit(jax.vmap(nll))(theta0, ys)))
    f_fin = np.asarray(jax.device_get(opt.fun_val), dtype=np.float64)
    with np.errstate(invalid="ignore"):
        stuck = (~np.isfinite(f_fin)) | (
            f_fin >= f_init - rescue_tol * np.maximum(1.0, np.abs(f_init)))
        delta = f_fin - f_init
        med = np.nanmedian(delta)
        mad = np.nanmedian(np.abs(delta - med))
        # mad==0 (>=half the lanes share one improvement value) would
        # flag essentially every other lane; the stuck-rule above already
        # covers no-progress lanes, so skip the outlier rule then.
        if mad > 0:
            sigma = 1.4826 * mad
            stuck |= np.isfinite(delta) & (delta > med + outlier_z * sigma)
    idx = np.nonzero(stuck)[0]
    if idx.size == 0:
        return opt
    if verbose:
        print(f"  scipy fallback: rescuing {idx.size} stuck lanes "
              f"{idx.tolist()[:16]}{'...' if idx.size > 16 else ''}",
              flush=True)
    vg = jax.jit(jax.value_and_grad(nll))   # compiled ONCE, reused per lane
    # .copy(): device_get can return read-only views of host-shared
    # buffers (the stepped optimizer's best-iterate arrays).
    params_np = np.asarray(jax.device_get(opt.params)).copy()
    succ_np = np.asarray(jax.device_get(opt.success)).copy()
    iters_np = np.asarray(jax.device_get(opt.num_iters)).copy()
    theta_init64 = np.asarray(init_theta, dtype=np.float64)
    for i in idx:
        ys_i = ys[i]

        def f_np(x):
            v, gr = vg(jnp.asarray(x, dtype=theta0.dtype), ys_i)
            return float(v), np.asarray(gr, dtype=np.float64)

        res = minimize(f_np, theta_init64, method="L-BFGS-B", jac=True,
                       options={"maxiter": max_iters})
        if np.isfinite(res.fun) and (not np.isfinite(f_fin[i])
                                     or res.fun < f_fin[i]):
            params_np[i] = np.asarray(res.x, dtype=params_np.dtype)
            succ_np[i] = bool(res.success)
            f_fin[i] = res.fun
            iters_np[i] = int(res.nit)
            if verbose:
                print(f"    lane {i}: rescued nll={res.fun:.3f} "
                      f"({int(res.nit)} iters, success={res.success})",
                      flush=True)
    from chirpgp_tpu.fit.mle import MLEResult
    val_dtype = np.asarray(jax.device_get(opt.fun_val)).dtype
    return MLEResult(jnp.asarray(params_np),
                     jnp.asarray(f_fin.astype(val_dtype)),
                     jnp.asarray(iters_np), jnp.asarray(succ_np))


def _polish_lanes_f64(nll, init_theta, opt, ys, max_iters: int = 200,
                      verbose: bool = False):
    """Per-lane float64-CPU L-BFGS-B polish of the f32 device solution.

    The f32 NLL of this model family sits at O(1e3) nats, so float32
    resolves relative improvements only down to ~1e-4 -- the stepped
    optimizer stalls on a plateau the reference's float64 SciPy run
    descends well past (diagnosed on the CKFS column: the whole batch
    froze ~5-10x above the f64 optima, blinding the batch-relative
    rescue).  Re-running the SAME objective in float64 on the host CPU
    from each lane's f32 best iterate is a cheap warm-started local
    refinement (L-BFGS-B is monotone, so the polished iterate can only
    improve in f64 terms) that restores the reference's optimizer
    semantics exactly -- the reference runs everything f64 on CPU.

    Lanes whose f32 stage went non-finite are polished from the init
    instead.  ``success`` takes the polished run's SciPy flag (the
    reference's divergence contract).
    """
    from scipy.optimize import minimize

    params_np = np.asarray(jax.device_get(opt.params),
                           dtype=np.float64).copy()
    f_fin = np.asarray(jax.device_get(opt.fun_val), dtype=np.float64).copy()
    succ_np = np.asarray(jax.device_get(opt.success)).copy()
    iters_np = np.asarray(jax.device_get(opt.num_iters)).copy()
    ys64 = np.asarray(jax.device_get(ys), dtype=np.float64)
    init64 = np.asarray(jax.device_get(init_theta), dtype=np.float64)
    B = params_np.shape[0]

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(), jax.default_device(cpu):
        vg = jax.jit(jax.value_and_grad(nll))   # f64 CPU, compiled once
        # Prime the compile on the main thread so workers only execute.
        _ = vg(jnp.asarray(init64), jnp.asarray(ys64[0]))

    def polish_lane(i):
        # jax.enable_x64 / default_device contexts are THREAD-LOCAL:
        # each worker needs its own, else jnp.asarray silently builds
        # f32 arrays and the polish runs at the wrong precision.
        with jax.enable_x64(), jax.default_device(cpu):
            x0 = params_np[i]
            if not np.all(np.isfinite(x0)):
                x0 = init64
            ys_i = jnp.asarray(ys64[i])

            def f_np(x):
                v, gr = vg(jnp.asarray(x), ys_i)
                return float(v), np.asarray(gr, dtype=np.float64)

            return i, minimize(f_np, x0, method="L-BFGS-B", jac=True,
                               options={"maxiter": max_iters})

    # The per-lane SciPy runs are independent and their cost is dominated
    # by the jitted f64 evals (GIL-released native compute), so a small
    # thread pool gives near-linear speedup on the available cores.  All
    # result mutation happens on the main thread, in lane order.
    import concurrent.futures as _cf
    workers = max(2, min(4, os.cpu_count() or 2))
    with _cf.ThreadPoolExecutor(max_workers=workers) as ex:
        for i, res in ex.map(polish_lane, range(B)):
            # Acceptance guard (round-3 advisor): polish from a FINITE f32
            # iterate is monotone in f64 terms, so a polished value above
            # the incoming one (beyond f32<->f64 evaluation slack, ~1e-4
            # relative at O(1e3) nats) signals the polish ran from the
            # init64 fallback and never converged -- keep the f32 result.
            # Lanes whose f32 stage went non-finite have no result to
            # keep; accept their init64-restart polish only when SciPy
            # itself reports convergence.
            incoming_finite = np.isfinite(f_fin[i])
            slack = 1e-3 * max(1.0, abs(f_fin[i])) if incoming_finite else 0.0
            accept = np.isfinite(res.fun) and (
                (incoming_finite and res.fun <= f_fin[i] + slack)
                or (not incoming_finite and bool(res.success)))
            if accept:
                if verbose and (not incoming_finite
                                or res.fun < f_fin[i] - 1e-3):
                    print(f"    f64 polish lane {i}: "
                          f"{f_fin[i]:.3f} -> {res.fun:.3f} "
                          f"({int(res.nit)} iters)", flush=True)
                params_np[i] = np.asarray(res.x)
                f_fin[i] = res.fun
                # The reference's contract is NaN-on-DIVERGENCE
                # (jobs/ghfs_mle.py:78-81): a finite polished optimum from
                # a finite f32 iterate is a usable estimate even if SciPy
                # stopped on maxiter, so don't demote the lane for that.
                succ_np[i] = True
                iters_np[i] = iters_np[i] + int(res.nit)
            elif verbose:
                print(f"    f64 polish lane {i}: rejected "
                      f"(fun={res.fun:.3f} vs incoming {f_fin[i]:.3f}, "
                      f"success={res.success})", flush=True)

    from chirpgp_tpu.fit.mle import MLEResult
    # Return in the f32-stage dtypes (f64 under x64 tests) so downstream
    # jits see consistent carry dtypes against the measurements.
    p_dtype = np.asarray(jax.device_get(opt.params)).dtype
    v_dtype = np.asarray(jax.device_get(opt.fun_val)).dtype
    return MLEResult(jnp.asarray(params_np.astype(p_dtype)),
                     jnp.asarray(f_fin.astype(v_dtype)),
                     jnp.asarray(iters_np), jnp.asarray(succ_np))


def mle_sweep_on_measurements(cfg: IFEstimationConfig,
                              true_freqs: jnp.ndarray, ys: jnp.ndarray,
                              init_theta: Optional[jnp.ndarray] = None,
                              polish_f64: bool = True,
                              checkpoint_path: Optional[str] = None,
                              checkpoint_tag: str = "",
                              verbose: bool = False) -> Dict[str, np.ndarray]:
    """Host-stepped batched MLE sweep over pre-generated measurement
    batches ``(B, T)`` -- lets callers mix scenarios (e.g. all three
    magnitude cases) in ONE batched L-BFGS program.

    ``polish_f64`` appends the per-lane float64-CPU warm-started polish
    (:func:`_polish_lanes_f64`) that closes the f32 plateau gap to the
    reference's f64 optimizer semantics.  ``checkpoint_path`` enables
    the stepped optimizer's crash-recovery checkpointing (resume an
    interrupted sweep from the same path; the file is NOT deleted here
    -- callers harvest the result first, then remove it)."""
    if init_theta is None:
        init_theta = cfg.default_init_theta()
    flt, smt = _filter_fns(cfg)
    v_idx = -2 if cfg.model == "harmonic" else 2

    def nll(theta, ys_i):
        return make_nll_fn(cfg, ys_i)(theta)

    theta0 = jnp.broadcast_to(init_theta, (ys.shape[0],) + init_theta.shape)
    opt = lbfgs_minimize_stepped(nll, theta0, batch_args=(ys,),
                                 max_iters=cfg.max_iters,
                                 ftol_rel=cfg.ftol_rel,
                                 patience=cfg.stall_patience,
                                 checkpoint_path=checkpoint_path,
                                 checkpoint_tag=checkpoint_tag,
                                 tail_iters=30,
                                 verbose=verbose)
    opt = _rescue_stuck_lanes(nll, init_theta, theta0, ys, opt,
                              max_iters=cfg.max_iters, verbose=verbose)
    if polish_f64:
        opt = _polish_lanes_f64(nll, init_theta, opt, ys,
                                max_iters=cfg.max_iters, verbose=verbose)

    def estimate(theta, tf_i, ys_i, success):
        params = g(theta)
        pack = cfg.build(params)
        mfs, Pfs, _ = flt(pack, ys_i)
        mss, Pss = smt(pack, mfs, Pfs)
        v_mean = mss[:, v_idx]
        if cfg.form == "sqrt":
            v_std = jnp.linalg.norm(Pss[:, v_idx, :], axis=-1)
        else:
            v_std = jnp.sqrt(jnp.maximum(Pss[:, v_idx, v_idx], 0.0))
        if_mean = gaussian_expectation_1d(
            v_mean, v_std, order=cfg.expectation_order) * cfg.freq_scale
        err = rmse(tf_i, if_mean)
        return dict(rmse=jnp.where(success, err, jnp.nan), params=params,
                    success=success)

    out = jax.jit(jax.vmap(estimate))(opt.params, true_freqs, ys,
                                      opt.success)
    return {k: np.asarray(v) for k, v in jax.device_get(out).items()}


def mc_kpt_sweep(keys: jnp.ndarray, mag_name: str, Xi: float = 0.1,
                 dt: float = 1e-3, T: int = 3141, num_harmonics: int = 1,
                 max_iters: int = 100, mesh=None, stepped: bool = True,
                 verbose: bool = False) -> Dict[str, np.ndarray]:
    """KPT-baseline MC sweep (reference ``tetralith/jobs/kpt_mle.py`` /
    ``harmonic_kpt_mle.py``): per seed, learn [q1, q2, p0, f0, a0] by
    EKF-marginal MLE, smooth with the linear RTS, estimate the IF,
    record RMSE (NaN on divergence).

    ``stepped=True`` (default) runs the batched host-stepped L-BFGS with
    the per-lane SciPy rescue -- one short device dispatch per iteration,
    with the same stuck-lane semantics as the main SSM sweeps.  ``stepped=False`` keeps
    the legacy monolithic in-JAX L-BFGS under vmap (one long dispatch)."""
    from chirpgp_tpu.apps.kpt import (
        KPT_INIT_PARAMS, kpt_filter, kpt_mle, kpt_if_estimate)
    from chirpgp_tpu.models import g as g_fn, g_inv

    fs = 1.0 / dt

    if stepped:
        gen = partial(toymodel_measurements, mag_name=mag_name, dt=dt,
                      T=T, Xi=Xi, num_harmonics=num_harmonics)
        _, tfs, yss = jax.jit(jax.vmap(gen))(keys)

        def nll(theta, ys_i):
            return kpt_filter(g_fn(theta), fs, Xi, ys_i,
                              num_harmonics=num_harmonics)[2][-1]

        init_theta = g_inv(jnp.asarray(KPT_INIT_PARAMS))
        theta0 = jnp.broadcast_to(init_theta,
                                  (yss.shape[0],) + init_theta.shape)
        opt = lbfgs_minimize_stepped(nll, theta0, batch_args=(yss,),
                                     max_iters=max_iters, ftol_rel=1e-9,
                                     patience=10, tail_iters=30,
                                     verbose=verbose)
        opt = _rescue_stuck_lanes(nll, init_theta, theta0, yss, opt,
                                  max_iters=max_iters, verbose=verbose)
        # Same f64-CPU polish as the SSM sweeps: a handful of harmonic-KPT
        # lanes land on an f32 plateau several x above the f64 optimum the
        # reference reaches (seeds 4/35 damped, diagnosed r3).
        opt = _polish_lanes_f64(nll, init_theta, opt, yss,
                                max_iters=max_iters, verbose=verbose)

        def est(theta, tf_i, ys_i, success):
            params = g_fn(theta)
            if_mean, _ = kpt_if_estimate(params, fs, Xi, ys_i,
                                         num_harmonics=num_harmonics)
            err = rmse(tf_i, if_mean)
            return dict(rmse=jnp.where(success, err, jnp.nan),
                        params=params, success=success)

        out = jax.jit(jax.vmap(est))(opt.params, tfs, yss, opt.success)
        return {k: np.asarray(v) for k, v in jax.device_get(out).items()}

    def per_seed(key):
        ts, true_freqs, ys = toymodel_measurements(
            key, mag_name, dt=dt, T=T, Xi=Xi,
            num_harmonics=num_harmonics)
        opt = kpt_mle(fs, Xi, ys, num_harmonics=num_harmonics,
                      max_iters=max_iters)
        params = g_fn(opt.params)
        if_mean, _ = kpt_if_estimate(params, fs, Xi, ys,
                                     num_harmonics=num_harmonics)
        err = rmse(true_freqs, if_mean)
        err = jnp.where(opt.success, err, jnp.nan)
        return dict(rmse=err, params=params, success=opt.success)

    if mesh is not None:
        from chirpgp_tpu.parallel import sharded_seed_sweep
        out = sharded_seed_sweep(per_seed, keys, mesh)
    else:
        out = jax.jit(jax.vmap(per_seed))(keys)
    return {k: np.asarray(v) for k, v in jax.device_get(out).items()}


def save_results(results: Dict[str, np.ndarray], method: str,
                 mag_name: str, out_dir: str = "./results"):
    """Write the reference-compatible result file
    ``{method}_{mag}.npz`` (cf. ``jobs/ghfs_mle.py:83-84``)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{method}_{mag_name}.npz")
    np.savez(path, **results)
    return path


def print_rmse_table(results_by_method: Dict[str, Dict[str, np.ndarray]],
                     scale: float = 10.0) -> str:
    """Aggregate per-method RMSE statistics like the reference table
    printer (``paper_plots_tables/print_rmse_table.py:14-56``): scaled
    mean +- std / median / min and the NaN (divergence) count."""
    lines = [f"{'method':24s} {'mag':8s} {'mean+-std':>20s} "
             f"{'median':>9s} {'min':>9s} {'#nan':>5s}"]
    for method, by_mag in results_by_method.items():
        for mag_name, res in by_mag.items():
            r = np.asarray(res["rmse"]) * scale
            nan_count = int(np.sum(np.isnan(r)))
            ok = r[~np.isnan(r)]
            if ok.size:
                lines.append(
                    f"{method:24s} {mag_name:8s} "
                    f"{np.mean(ok):9.3f}+-{np.std(ok):8.3f} "
                    f"{np.median(ok):9.3f} {np.min(ok):9.3f} {nan_count:5d}")
            else:
                lines.append(f"{method:24s} {mag_name:8s} {'all-NaN':>20s} "
                             f"{'--':>9s} {'--':>9s} {nan_count:5d}")
    table = "\n".join(lines)
    print(table)
    return table
