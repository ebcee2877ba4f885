"""Bisect the lascala_ghfs sqrt-form device fault (ROADMAP R9).

On the first backend the sqrt-form stepped MLE program for the La Scala
model faulted the device worker at B>=100, so the Table-I column ships in
covariance form (``experiments/run_rmse_table.py`` METHOD_CONFIGS note).
This driver bisects a failure over (a) batch size, (b) program fragment
(filter fwd only / value_and_grad / full L-BFGS step).  Whether the fault
exists on the H100 is not yet tried.

Run each stage in a separate process (a fault may kill the process):
    python experiments/repro_lascala_sqrt_fault.py --stage fwd --B 100
    python experiments/repro_lascala_sqrt_fault.py --stage grad --B 100
    python experiments/repro_lascala_sqrt_fault.py --stage step --B 100
"""

# Allow running straight from a source checkout (no pip install).
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", required=True,
                    choices=["fwd", "grad", "step"])
    ap.add_argument("--B", type=int, default=100)
    ap.add_argument("--T", type=int, default=3141)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from chirpgp_tpu.apps import IFEstimationConfig, make_nll_fn
    from chirpgp_tpu.apps.sweeps import toymodel_measurements
    from chirpgp_tpu.fit.mle import lbfgs_minimize_stepped

    cfg = IFEstimationConfig(method="ghfs", model="lascala", form="sqrt")
    keys = jax.random.split(jax.random.PRNGKey(999), args.B)
    import functools
    gen = functools.partial(toymodel_measurements, mag_name="const",
                            dt=cfg.dt, T=args.T, Xi=cfg.Xi)
    _, _, yss = jax.jit(jax.vmap(gen))(keys)
    init = cfg.default_init_theta()
    theta0 = jnp.broadcast_to(init, (args.B,) + init.shape)

    def nll(theta, ys_i):
        return make_nll_fn(cfg, ys_i)(theta)

    t0 = time.time()
    if args.stage == "fwd":
        out = jax.jit(jax.vmap(nll))(theta0, yss)
        jax.block_until_ready(out)
        print(f"fwd ok B={args.B}: median nll="
              f"{float(jnp.median(out)):.3f} ({time.time()-t0:.1f}s)")
    elif args.stage == "grad":
        vg = jax.jit(jax.vmap(jax.value_and_grad(nll)))
        v, g_ = vg(theta0, yss)
        jax.block_until_ready(v)
        print(f"grad ok B={args.B}: median nll={float(jnp.median(v)):.3f} "
              f"finite grad={bool(jnp.all(jnp.isfinite(g_)))} "
              f"({time.time()-t0:.1f}s)")
    else:
        res = lbfgs_minimize_stepped(nll, theta0, batch_args=(yss,),
                                     max_iters=3, verbose=True)
        print(f"step ok B={args.B}: median nll="
              f"{float(jnp.median(res.fun_val)):.3f} "
              f"({time.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
