"""Benchmark: fused filter+smoother throughput on the canonical chirp
config (T=3141, d=4, Gauss-Hermite order 3 -- ``demos/ghfs_mle.py:20-34``)
on one GPU.

A batch of B=4096 independent Monte-Carlo seeds runs the fused sqrt
sigma-point filter + smoother (``infer/batched.py``) and the IF
expectation, jitted, in float32.  The metric is filter+smoother
time-steps per second (B * T / best-of-5 wall time).  Speed is never
reported without the CKFS seed-0 accuracy gate.

Prints one JSON line naming the device (platform, kind, count) and the
card's power limit.  Exits non-zero when JAX finds no GPU or any step
fails.

    python bench.py
"""

import json
import math
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.abspath(__file__))

DT = 1e-3
T = 3141
XI = 0.1
BATCH = 4096
UNROLL = 4
REPEATS = 5

# CKFS seed-0 IF RMSE x10 at the reference's learnt optimum must not
# exceed this (the float64 reference reads 0.776).
ACC_GATE = 0.80


def require_gpu():
    """Return ``jax.devices()[0]``; exit 2 when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU found (JAX platform {dev.platform!r}); refusing to "
              f"run", file=sys.stderr)
        sys.exit(2)
    return dev


def device_record():
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit line(s) for the cards."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def fused_if_means(m_and_cov, rule, H, Xi, m0, P0, dt, yss,
                   unroll: int = UNROLL):
    """IF posterior means (B, T) and final NLLs (B,) from the fused
    batched filter+smoother (covariance backward pass) -- the timed
    kernel."""
    from chirpgp_tpu.infer.batched import (
        sqrt_sgp_filter_smoother_batched, gaussian_expectation_batched)
    mss, Pss, nll = sqrt_sgp_filter_smoother_batched(
        m_and_cov, rule, H, Xi, m0, P0, dt, yss,
        return_factors=False, unroll=unroll)
    v_std = jnp.sqrt(jnp.maximum(Pss[:, 2, 2, :], 0.0))
    if_means = gaussian_expectation_batched(mss[:, 2, :], v_std)
    return if_means.T, nll[-1]


def accuracy_gate_rmse_x10() -> float:
    """CKFS (cubature) seed-0 IF RMSE x10 of the fused float32 kernel at
    the reference's learnt optimum, under whatever matmul precision is
    active.  Wrong kernels or a too-coarse matmul precision push it
    above ``ACC_GATE``."""
    import numpy as np
    from chirpgp_tpu.apps import IFEstimationConfig
    from chirpgp_tpu.utils import rmse

    data = np.load(os.path.join(ROOT, "results/data/toydata_const.npz"))
    ref = np.load(os.path.join(ROOT, "results/reference/ckfs_const.npz"))
    ys1 = jnp.asarray(data["ys"][:1], jnp.float32)
    tf = jnp.asarray(data["true_freqs"], jnp.float32)
    cfg = IFEstimationConfig(method="ghfs", quadrature="cubature",
                             form="sqrt")
    pack = cfg.build(jnp.asarray(ref["params"][0], jnp.float32))
    rule = cfg.sigma_points()

    @jax.jit
    def run(ys_):
        return fused_if_means(pack.m_and_cov, rule, pack.H.astype(ys_.dtype),
                              jnp.float32(cfg.Xi), pack.m0.astype(ys_.dtype),
                              pack.P0.astype(ys_.dtype), jnp.float32(cfg.dt),
                              ys_)[0]

    return float(rmse(tf, run(ys1)[0])) * 10.0


def main():
    from chirpgp_tpu.apps import IFEstimationConfig
    from chirpgp_tpu.models import g
    from chirpgp_tpu.toymodels import gen_chirp, constant_mag, meow_freq

    require_gpu()
    power = gpu_name_and_power_limit()

    ts = jnp.linspace(DT, DT * T, T, dtype=jnp.float32)
    _, phase_func = meow_freq(offset=8.0)
    base = gen_chirp(ts, constant_mag(1.0), phase_func)
    keys = jax.random.split(jax.random.PRNGKey(999), BATCH)
    yss = base[None, :] + math.sqrt(XI) * jax.vmap(
        lambda k: jax.random.normal(k, (T,), dtype=jnp.float32))(keys)

    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    pack = cfg.build(g(cfg.default_init_theta()).astype(jnp.float32))
    rule = cfg.sigma_points()
    args = (pack.m_and_cov, rule, pack.H.astype(jnp.float32),
            jnp.float32(XI), pack.m0.astype(jnp.float32),
            pack.P0.astype(jnp.float32), jnp.float32(DT))
    fn = jax.jit(lambda y: fused_if_means(*args, y))

    t0 = time.perf_counter()
    if_means, _ = jax.block_until_ready(fn(yss))
    first_s = time.perf_counter() - t0
    if not bool(jnp.all(jnp.isfinite(if_means))):
        raise FloatingPointError("non-finite IF means in the timed kernel")
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(yss))
        times.append(time.perf_counter() - t0)
    best = min(times)

    acc = accuracy_gate_rmse_x10()
    if not acc <= ACC_GATE:
        raise AssertionError(f"accuracy gate failed: CKFS seed-0 RMSE x10 "
                             f"{acc:.4f} > {ACC_GATE}")

    print(json.dumps({
        "metric": "ghfs_filter_smoother_steps_per_sec",
        "value": BATCH * T / best,
        "unit": (f"steps/s (batch={BATCH} seeds, T={T}, d=4, GH-3, f32, "
                 f"sqrt fused, unroll={UNROLL})"),
        "best_s": best,
        "first_call_s": first_s,
        "acc_gate_rmse_x10": acc,
        "matmul_precision": str(jax.config.jax_default_matmul_precision),
        "device": device_record(),
        "nvidia_smi": power,
    }), flush=True)


if __name__ == "__main__":
    main()
