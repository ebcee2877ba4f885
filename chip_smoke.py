"""Run the main path of chirpgp_tpu once on one NVIDIA GPU and check it.

Phases, in one process on one card, run in the order P2, P1, P3, P4:

P1  batched Monte-Carlo IF estimation, B=4096 seeds x T=3141, d=4,
    Gauss-Hermite order 3 (81 points), float32, unroll=4:
    ``estimate_if_batched`` and the fused filter+smoother that ``bench.py``
    times, at the reference optimum, checked against the float64
    covariance-form ``estimate_if`` on 16 lanes, computed on the card.
P2  the CKFS seed-0 accuracy gate (``bench.accuracy_gate_rmse_x10``) under
    the package's matmul precision and, if that is another, "highest".
P3  single-record fit (``run_pipeline``) on committed row 0, with the
    default SciPy optimizer and with the in-JAX L-BFGS (30 iterations).
P4  5 stepped batched L-BFGS iterations over B=300 records (the Table-I
    sweep's training loop), and one float32 NLL gradient against float64.

``--four`` runs the four-card path instead, and nothing else: the P1
per-seed ``estimate_if`` sharded over a 4-device mesh against the
one-card result, the ``psum`` mean, and the time-sharded parallel KF/RTS
at T=25,000 against the sequential scans.

Every float32 result runs under the package's matmul precision; every
float64 reference runs under ``jax.default_matmul_precision("highest")``.
Each check prints its value, bound and reason.  The script exits non-zero,
printing no result line, when JAX finds no GPU or any check fails.  The
last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

    python chip_smoke.py            # one card
    python chip_smoke.py --four     # four cards of one host
"""

import argparse
import json
import os
import sys
import time
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

import bench
from chirpgp_tpu.apps import (
    IFEstimationConfig, estimate_if, estimate_if_batched, make_nll_fn,
    run_pipeline, toymodel_measurements)
from chirpgp_tpu.fit.mle import lbfgs_minimize_stepped
from chirpgp_tpu.infer import kf, rts
from chirpgp_tpu.infer.parallel_sharded import (
    kf_parallel_time_sharded, rts_parallel_time_sharded)
from chirpgp_tpu.models import m32_solution, stationary_cov_m32
from chirpgp_tpu.parallel import make_mesh, sharded_mean, sharded_seed_sweep
from chirpgp_tpu.utils import rmse

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "results", "data")
REF = os.path.join(ROOT, "results", "reference")

T_FULL = 3141
UNROLL = 4

# Each float32 bound sits between two readings on an NVIDIA H100 80GB HBM3
# (700 W) at the full widths: the sound one, with full float32 products
# (matmul precision "highest"), and the control, with TF32 products
# ("high"), which the bounds exist to catch.
#
# Float32 against float64 on the same data and parameters, worst IF sample
# of 16 lanes: sound 2.3e-5 Hz (batched) and 3.1e-5 Hz (fused), control
# 0.012 Hz and 0.024 Hz.  Per-lane IF RMSE, relative: sound 4.1e-5 and
# 3.6e-5, control 0.013 and 0.012.
TOL_IF_HZ = 1e-3
TOL_RMSE_REL = 1e-3
# Fused filter+smoother against estimate_if_batched, the same posterior by
# two float32 algebras (joint-factor covariance backward pass against the
# separate sqrt smoother): sound 5.3e-5 Hz, control 0.068 Hz.
TOL_FUSED_HZ = 1e-3
# The fitted record's IF RMSE over the float64 reference fit's (SciPy
# L-BFGS-B on the same record, 0.0786): sound 0.992 (SciPy) and 1.000
# (in-JAX L-BFGS), control 1.13 (SciPy stopped after 11 iterations).
FIT_RMSE_FACTOR = 1.05
# Float32 NLL and gradient (2-norm) against float64 at the init point, one
# record: control 0.021 and 0.13; the same float32 code on a CPU, where
# products are exact at every precision, reads 1.1e-5 and 8e-5.
TOL_NLL_REL = 1e-3
TOL_GRAD_REL = 2e-2
# Time-sharded parallel KF/RTS: float32 smoothed means within 1% of the
# float64 sequential scan's scale (associative scans reorder float32
# sums); float64 sharded against float64 sequential to 1e-6 of scale (the
# decomposition is exact).
TOL_LONG32_REL = 1e-2
TOL_LONG64_REL = 1e-6


class Check(NamedTuple):
    name: str
    value: float
    bound: float
    reason: str

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value) and self.value <= self.bound)


def _say(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def _report(phase: str, checks: List[Check]):
    for c in checks:
        _say(phase, f"check {c.name}: {c.value:.6g} <= {c.bound:.6g} "
                    f"{'ok' if c.ok else 'FAIL'} ({c.reason})")


def _memory(phase: str, label: str):
    stats = jax.devices()[0].memory_stats()
    if stats:
        _say(phase, f"{label}: peak_bytes_in_use="
                    f"{stats.get('peak_bytes_in_use')} bytes_in_use="
                    f"{stats.get('bytes_in_use')}")


def _compile_and_run(phase: str, label: str, fn, *args):
    """Compile ``fn`` for ``args``, run it once, print compile and run
    times and XLA's memory analysis; returns the output."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t_run = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    sizes = "" if mem is None else (
        f" args={mem.argument_size_in_bytes} out={mem.output_size_in_bytes}"
        f" temp={mem.temp_size_in_bytes} bytes")
    dev = ",".join(sorted(str(d) for d in jax.tree.leaves(out)[0].devices()))
    _say(phase, f"{label} on {dev}: compile {t_compile:.2f}s, run "
                f"{t_run:.3f}s{sizes}")
    return out


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def mc_inputs(B: int, T: int, seed: int):
    """``(ys (B, T) f32, true_freqs (T,) f32, params (6,) f64)``: the
    committed constant-magnitude rows, extended past 100 with
    ``toymodel_measurements`` from ``seed``, and the reference optimum of
    row 0."""
    data = np.load(os.path.join(DATA, "toydata_const.npz"))
    ys = np.asarray(data["ys"][:min(B, 100), :T], np.float32)
    if B > ys.shape[0]:
        keys = jax.random.split(jax.random.PRNGKey(seed), B - ys.shape[0])
        extra = jax.jit(jax.vmap(
            lambda k: toymodel_measurements(k, "const", T=T)[2]))(keys)
        ys = np.concatenate([ys, np.asarray(extra, np.float32)])
    tf = np.asarray(data["true_freqs"][:T], np.float32)
    params = np.load(os.path.join(REF, "ghfs_const.npz"))["params"][0]
    return ys, tf, params


def _f64_if_means(params, ys):
    """Plain reference: float64 covariance-form ``estimate_if`` per lane,
    vmapped, on the default device."""
    cfg = IFEstimationConfig(method="ghfs", form="cov")
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        p64 = jnp.asarray(params, jnp.float64)
        y64 = jnp.asarray(ys, jnp.float64)
        return np.asarray(jax.jit(jax.vmap(
            lambda y: estimate_if(cfg, p64, y)["if_mean"]))(y64))


def phase_mc(B: int = 4096, T: int = T_FULL, n_ref: int = 16,
             seed: int = 0) -> List[Check]:
    """P1: batched MC estimation at full width against float64."""
    ys, tf, params = mc_inputs(B, T, seed)
    ys_d = jnp.asarray(ys)
    p32 = jnp.asarray(params, jnp.float32)
    cfg = IFEstimationConfig(method="ghfs", form="sqrt", scan_unroll=UNROLL)
    _say("P1", f"B={B} T={T} d={cfg.state_dim()} "
               f"sigma points={cfg.sigma_points().xi.shape[0]} "
               f"unroll={UNROLL} float32")

    if_b = _compile_and_run(
        "P1", "estimate_if_batched",
        lambda p, y: estimate_if_batched(cfg, p, y)["if_mean"], p32, ys_d)
    pack = cfg.build(p32)
    fused_args = (pack.m_and_cov, cfg.sigma_points(),
                  pack.H.astype(jnp.float32), jnp.float32(cfg.Xi),
                  pack.m0.astype(jnp.float32), pack.P0.astype(jnp.float32),
                  jnp.float32(cfg.dt))
    if_f = _compile_and_run(
        "P1", "fused filter+smoother (bench kernel)",
        lambda y: bench.fused_if_means(*fused_args, y, unroll=UNROLL)[0],
        ys_d)
    _memory("P1", "after the batched runs")

    t0 = time.perf_counter()
    ref = _f64_if_means(params, ys[:n_ref])
    _say("P1", f"float64 cov-form estimate_if x{n_ref} lanes (highest "
               f"precision): {time.perf_counter() - t0:.2f}s incl. compile")

    if_b, if_f = np.asarray(if_b), np.asarray(if_f)
    checks = [
        Check("shapes", float(if_b.shape != (B, T) or if_f.shape != (B, T)),
              0.0, "both IF means are (B, T)"),
        Check("nonfinite", float(np.sum(~np.isfinite(if_b))
                                 + np.sum(~np.isfinite(if_f))),
              0.0, "every IF sample finite"),
        Check("fused_vs_batched_hz", _max_abs(if_f, if_b), TOL_FUSED_HZ,
              "same posterior, two float32 algebras"),
    ]
    rm_ref = np.array([float(rmse(tf, r)) for r in ref])
    for label, est in (("batched", if_b), ("fused", if_f)):
        rm = np.array([float(rmse(tf, e)) for e in est[:n_ref]])
        checks += [
            Check(f"{label}_vs_f64_if_hz", _max_abs(est[:n_ref], ref),
                  TOL_IF_HZ, "float32 rounding vs float64, worst sample"),
            Check(f"{label}_vs_f64_rmse_rel",
                  float(np.max(np.abs(rm - rm_ref) / rm_ref)),
                  TOL_RMSE_REL, "per-lane IF RMSE vs float64"),
        ]
    _say("P1", f"per-lane IF RMSE (float64 ref, first lanes): "
               f"{np.round(rm_ref[:4], 5).tolist()}")
    return checks


def phase_gate() -> List[Check]:
    """P2: CKFS seed-0 accuracy gate under the package precision and,
    when that is another, under "highest"."""
    pkg = jax.config.jax_default_matmul_precision or "default"
    checks = []
    for prec in [pkg] if pkg == "highest" else [pkg, "highest"]:
        t0 = time.perf_counter()
        with jax.default_matmul_precision(prec):
            value = bench.accuracy_gate_rmse_x10()
        _say("P2", f"CKFS seed 0, T={T_FULL}, B=1, fused float32 kernel, "
                   f"{prec}: {time.perf_counter() - t0:.2f}s incl. compile")
        checks.append(Check(f"gate_rmse_x10[{prec}]", value, bench.ACC_GATE,
                            "float64 reference reads 0.776"))
    return checks


def phase_fit(T: int = T_FULL, max_iters: int = 200,
              lbfgs_iters: int = 30) -> List[Check]:
    """P3: ``run_pipeline`` on committed row 0 with each optimizer.

    The in-JAX L-BFGS stops on a gradient norm of 1e-6, which a float32
    objective never reaches, so it runs to its cap: ``lbfgs_iters`` (30;
    SciPy converges in ~30 on this record, and 30 lands on the same IF
    RMSE as 200 on a CPU, 0.0786) bounds its cost."""
    data = np.load(os.path.join(DATA, "toydata_const.npz"))
    ys = jnp.asarray(data["ys"][0, :T], jnp.float32)
    tf = jnp.asarray(data["true_freqs"][:T], jnp.float32)
    ref_rmse = float(np.load(os.path.join(REF, "ghfs_const.npz"))["rmse"][0])
    checks = []
    for optimizer in ("scipy", "lbfgs"):
        cfg = IFEstimationConfig(
            method="ghfs", form="sqrt", optimizer=optimizer,
            max_iters=max_iters if optimizer == "scipy" else lbfgs_iters)
        t0 = time.perf_counter()
        opt, _, est = run_pipeline(cfg, ys)
        if_mean = jax.block_until_ready(est["if_mean"])
        wall = time.perf_counter() - t0
        err = float(rmse(tf, if_mean))
        _say("P3", f"run_pipeline ghfs sqrt T={T} optimizer={optimizer} on "
                   f"{next(iter(if_mean.devices()))}: {wall:.2f}s incl. "
                   f"compile, {int(opt.num_iters)} iterations, IF RMSE "
                   f"{err:.5f} (float64 reference fit {ref_rmse:.5f})")
        checks.append(Check(f"{optimizer}_failed", float(not bool(opt.success)),
                            0.0, "optimizer reports success"))
        if T == T_FULL:
            checks.append(Check(
                f"{optimizer}_if_rmse", err, FIT_RMSE_FACTOR * ref_rmse,
                f"{FIT_RMSE_FACTOR} x the float64 reference fit's RMSE"))
        else:
            checks.append(Check(f"{optimizer}_if_rmse_finite",
                                float(not np.isfinite(err)), 0.0,
                                "shortened record: finite RMSE only"))
    return checks


FIT_CFG = IFEstimationConfig(method="ghfs", form="sqrt")


def _nll(theta, y):
    return make_nll_fn(FIT_CFG, y)(theta)


_nll_value_and_grad = jax.jit(jax.value_and_grad(_nll))


def nll_grad_rel_errors(theta, y):
    """Relative errors of one record's float32 filter NLL and of its
    gradient (``FIT_CFG``, active matmul precision) against the same in
    float64 at "highest" precision."""
    v32, g32 = _nll_value_and_grad(jnp.asarray(theta, jnp.float32),
                                   jnp.asarray(y, jnp.float32))
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        v64, g64 = _nll_value_and_grad(jnp.asarray(theta, jnp.float64),
                                       jnp.asarray(y, jnp.float64))
        v64, g64 = float(v64), np.asarray(g64)
    g32 = np.asarray(g32, np.float64)
    return (abs(float(v32) - v64) / abs(v64),
            float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64)))


def phase_grad_steps(n_per_mag: int = 100, T: int = T_FULL, iters: int = 5,
                     n_grad: int = 2) -> List[Check]:
    """P4: stepped batched L-BFGS over the committed Table-I rows, and a
    float32 gradient against float64."""
    ys = np.concatenate([
        np.load(os.path.join(DATA, f"toydata_{m}.npz"))["ys"][:n_per_mag, :T]
        for m in ("const", "damped", "random")]).astype(np.float32)
    ys_d = jnp.asarray(ys)
    cfg, nll = FIT_CFG, _nll
    theta_init = jnp.asarray(cfg.default_init_theta(), ys_d.dtype)
    theta0 = jnp.broadcast_to(theta_init, (ys.shape[0],) + theta_init.shape)
    f0 = np.asarray(jax.jit(jax.vmap(nll))(theta0, ys_d), np.float64)
    t0 = time.perf_counter()
    opt = lbfgs_minimize_stepped(nll, theta0, batch_args=(ys_d,),
                                 max_iters=iters, ftol_rel=cfg.ftol_rel,
                                 patience=cfg.stall_patience)
    f1 = np.asarray(jax.block_until_ready(opt.fun_val), np.float64)
    _say("P4", f"lbfgs_minimize_stepped B={ys.shape[0]} T={T} ghfs sqrt, "
               f"{iters} iterations on {next(iter(opt.fun_val.devices()))}: "
               f"{time.perf_counter() - t0:.2f}s incl. compile; median NLL "
               f"{np.median(f0):.3f} -> {np.median(f1):.3f}")
    _memory("P4", "after the stepped L-BFGS")
    checks = [
        Check("nonfinite_nll", float(np.sum(~np.isfinite(f1))), 0.0,
              "every lane's NLL finite"),
        Check("max_nll_increase", float(np.max(f1 - f0)), 0.0,
              "no lane ends above its initial NLL"),
        Check("neg_median_decrease", float(-np.median(f0 - f1)), 0.0,
              "the median lane improves"),
    ]

    for i in range(n_grad):
        nll_rel, grad_rel = nll_grad_rel_errors(theta_init, ys[i])
        checks += [
            Check(f"lane{i}_nll_rel", nll_rel, TOL_NLL_REL,
                  "float32 NLL vs float64"),
            Check(f"lane{i}_grad_rel", grad_rel, TOL_GRAD_REL,
                  "float32 gradient vs float64, 2-norm"),
        ]
    return checks


def _shard_devices(x) -> int:
    return len({s.device for s in x.addressable_shards})


def phase_four(B: int = 4096, T: int = T_FULL, T_long: int = 25000,
               seed: int = 0, n_dev: int = 4) -> List[Check]:
    """The four-card path: sharded seed sweep, psum mean, and the
    time-sharded parallel KF/RTS, each against its one-card result."""
    devs = jax.devices()[:n_dev]
    if len(devs) < n_dev:
        raise RuntimeError(f"--four needs {n_dev} devices, found "
                           f"{len(jax.devices())}")
    ys, tf, params = mc_inputs(B, T, seed)
    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    p32 = jnp.asarray(params, jnp.float32)
    tf_d = jnp.asarray(tf)

    def per_seed(y):
        return estimate_if(cfg, p32, y)["if_mean"]

    mesh = make_mesh(n_dev)
    t0 = time.perf_counter()
    one = np.asarray(jax.jit(jax.vmap(per_seed))(
        jax.device_put(jnp.asarray(ys), devs[0])))
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    shd = jax.block_until_ready(
        sharded_seed_sweep(per_seed, jnp.asarray(ys), mesh))
    t_shd = time.perf_counter() - t0
    _say("4", f"estimate_if per seed B={B} T={T}: one card {t_one:.2f}s, "
              f"{n_dev}-device mesh {t_shd:.2f}s (both incl. compile), "
              f"output on {_shard_devices(shd)} devices")

    mean_rmse = float(sharded_mean(lambda y: rmse(tf_d, per_seed(y)),
                                   jnp.asarray(ys), mesh))
    mean_one = float(np.mean([float(rmse(tf, o)) for o in one]))
    _say("4", f"sharded_mean IF RMSE {mean_rmse:.6f}, one card "
              f"{mean_one:.6f}")

    # Time-sharded M32 KF/RTS on the committed long record.
    ys_long = np.load(os.path.join(DATA, "parallel_kf_ref.npz"))[
        "ys_T25000"][:T_long]
    dt, Xi = 1e-3, 0.1
    outs = {}
    for dtype in (jnp.float32, jnp.float64):
        f64 = dtype == jnp.float64
        with jax.enable_x64(f64), jax.default_matmul_precision(
                "highest" if f64 else jax.config.jax_default_matmul_precision):
            F, Sig = (a.astype(dtype) for a in m32_solution(1.0, 1.0, dt))
            H = jnp.array([1.0, 0.0], dtype)
            P0 = stationary_cov_m32(1.0, 1.0).astype(dtype)
            m0 = jnp.zeros(2, dtype)
            y = jnp.asarray(ys_long, dtype)

            def seq(y_):
                mfs, Pfs, nll = kf(F, Sig, H, Xi, m0, P0, y_)
                return rts(F, Sig, mfs, Pfs)[0]

            tmesh = make_mesh(n_dev, axis_name="time")
            t0 = time.perf_counter()
            m_seq = np.asarray(jax.jit(seq)(jax.device_put(y, devs[0])))
            t_seq = time.perf_counter() - t0
            t0 = time.perf_counter()
            mfs, Pfs, _ = kf_parallel_time_sharded(F, Sig, H, Xi, m0, P0, y,
                                                   tmesh)
            m_par = jax.block_until_ready(
                rts_parallel_time_sharded(F, Sig, mfs, Pfs, tmesh)[0])
            t_par = time.perf_counter() - t0
            _say("4", f"M32 KF/RTS T={T_long} {jnp.dtype(dtype).name}: "
                      f"sequential {t_seq:.2f}s, time-sharded over "
                      f"{_shard_devices(mfs)} devices {t_par:.2f}s (both "
                      f"incl. compile)")
            outs[jnp.dtype(dtype).name] = (m_seq, np.asarray(m_par),
                                           _shard_devices(mfs))
    seq64, par64, n64 = outs["float64"]
    seq32, par32, n32 = outs["float32"]
    scale = float(np.max(np.abs(seq64)))
    return [
        Check("sweep_vs_one_card_hz", _max_abs(shd, one), TOL_IF_HZ,
              "same per-seed program, lane for lane"),
        Check("sweep_devices_short", float(n_dev - _shard_devices(shd)), 0.0,
              f"output spread over {n_dev} devices"),
        Check("sharded_mean_rel", abs(mean_rmse - mean_one) / mean_one,
              1e-4, "psum mean vs host mean of the one-card lanes"),
        Check("time_sharded_f64_rel", _max_abs(par64, seq64) / scale,
              TOL_LONG64_REL, "exact decomposition, float64"),
        Check("time_sharded_f32_rel", _max_abs(par32, seq64) / scale,
              TOL_LONG32_REL, "float32 associative scan vs float64"),
        Check("sequential_f32_rel", _max_abs(seq32, seq64) / scale,
              TOL_LONG32_REL, "float32 sequential scan vs float64"),
        Check("time_shard_devices_short", float(2 * n_dev - n32 - n64), 0.0,
              f"filter output spread over {n_dev} devices"),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the measurement rows past the 100 "
                         "committed ones")
    args = ap.parse_args(argv)

    bench.require_gpu()
    smi = bench.gpu_name_and_power_limit()
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"JAX {jax.__version__}, {len(jax.devices())} x "
          f"{jax.devices()[0].device_kind}, matmul precision "
          f"{jax.config.jax_default_matmul_precision or 'default'}",
          flush=True)

    if args.four:
        phases = [("4", lambda: phase_four(seed=args.seed))]
    else:
        phases = [("P2", phase_gate),
                  ("P1", lambda: phase_mc(seed=args.seed)),
                  ("P3", phase_fit), ("P4", phase_grad_steps)]
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        checks = fn()
        _report(name, checks)
        _say(name, f"phase wall {time.perf_counter() - t0:.2f}s")
        failed += [f"{name}:{c.name}" for c in checks if not c.ok]
    print(f"total {time.perf_counter() - t_all:.2f}s on {smi}", flush=True)
    if failed:
        print(f"FAILED checks: {failed}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": bench.device_record()}))


if __name__ == "__main__":
    main()
