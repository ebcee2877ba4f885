"""Toy-chirp IF estimation with a Gauss--Hermite sigma-point filter and
smoother, hyperparameters learnt by MLE.

Accelerator counterpart of the reference demo ``demos/ghfs_mle.py``: same
experiment contract (dt=1e-3, T=3141, meow IF offset 8, Xi=0.1, three
magnitude scenarios, GH order 3, init theta g^{-1}([.1,.1,.1,1,1,7])), but
the optimizer is the in-JAX L-BFGS so the whole MLE jits, and ``--form
sqrt`` selects the float32-safe square-root path.

Usage: python demos/ghfs_mle.py [--method ghfs] [--form cov|sqrt] [--plot]
"""

# Allow running straight from a source checkout (no pip install).
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import math

import jax
import jax.numpy as jnp

from chirpgp_tpu.apps import IFEstimationConfig, run_pipeline
from chirpgp_tpu.toymodels import (
    gen_chirp, constant_mag, damped_exp_mag, random_ou_mag, meow_freq)
from chirpgp_tpu.utils import rmse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="ghfs",
                    choices=["ghfs", "ekfs", "cd_ghfs", "cd_ekfs"])
    ap.add_argument("--form", default="cov", choices=["cov", "sqrt"])
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--max-iters", type=int, default=100)
    ap.add_argument("--optimizer", default="scipy",
                    choices=["scipy", "lbfgs"],
                    help="scipy: host L-BFGS-B with short device dispatches "
                         "(the reference's optimizer); lbfgs: fully "
                         "in-JAX (fastest for batched sweeps)")
    ap.add_argument("--x64", action="store_true",
                    help="enable float64 (CPU only)")
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args()

    if args.x64:
        jax.config.update("jax_enable_x64", True)

    dt, T, Xi = 1e-3, args.T, 0.1
    ts = jnp.linspace(dt, dt * T, T)
    true_freq_func, true_phase_func = meow_freq(offset=8.0)

    key = jax.random.PRNGKey(555)
    key, subkey = jax.random.split(key)

    cfg = IFEstimationConfig(dt=dt, Xi=Xi, method=args.method,
                             form=args.form, max_iters=args.max_iters,
                             optimizer=args.optimizer)

    for name, mag in [("const", constant_mag(1.0)),
                      ("damped", damped_exp_mag(0.3)),
                      ("random_ou", random_ou_mag(1.0, 1.0, subkey))]:
        true_chirp = gen_chirp(ts, mag, true_phase_func)
        ys = true_chirp + math.sqrt(Xi) * jax.random.normal(key, (T,))

        opt, params, est = run_pipeline(cfg, ys)
        err = rmse(true_freq_func(ts), est["if_mean"])
        print(f"[{name}] learnt params: {params}  "
              f"converged={bool(opt.success)} ({int(opt.num_iters)} iters)")
        print(f"[{name}] IF RMSE: {float(err):.4f}")

        if args.plot:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            plt.figure()
            plt.plot(ts, true_freq_func(ts), "--", label="True frequency")
            plt.plot(ts, est["if_mean"], "k", label="Estimated")
            plt.fill_between(ts, est["if_lower"], est["if_upper"],
                             alpha=0.15, color="k", edgecolor="none")
            plt.legend()
            plt.savefig(f"{args.method}_{name}_if.png", dpi=120)
            plt.close()


if __name__ == "__main__":
    main()
