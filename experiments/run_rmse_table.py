"""Monte-Carlo RMSE-table experiment (paper Table I reproduction).

Accelerator counterpart of the reference's per-method Slurm jobs
(``tetralith/jobs/*_mle.py`` + ``paper_plots_tables/print_rmse_table.py``):
instead of a sequential Python loop per seed per method, each method's
100-seed sweep runs as ONE sharded program over the device mesh; results
are written as idempotent .npz files and aggregated into the reference's
table format (RMSE x10 mean+-std / median / min / #NaN).

Usage:
    python experiments/run_rmse_table.py --methods ghfs ekfs --seeds 100
    python experiments/run_rmse_table.py --methods all --out ./results
"""

# Allow running straight from a source checkout (no pip install).
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import jax


# One entry per SSM column of the reference's Table I
# (``paper_plots_tables/print_rmse_table.py:14-16`` single-chirp block and
# ``:93-96`` harmonic block; the classical/native baselines hilbert /
# spectrogram / poly / anf / fastf0nls / fhc / kpt have their own runners).
# "form" is the per-method default covariance representation: the QR
# square-root form is the float32-safe path and is used wherever the
# method supports it; the CD (continuous-discrete RK4 moment-ODE) variants
# run in covariance form.
METHOD_CONFIGS = {
    # method name -> IFEstimationConfig kwargs
    "ghfs": dict(method="ghfs", form="sqrt"),
    "ekfs": dict(method="ekfs", form="sqrt"),
    # CKFS = sigma-point filter with the spherical-cubature rule on the
    # chirp model (the reference table's ckfs_mle column).
    "ckfs": dict(method="ghfs", quadrature="cubature", form="sqrt"),
    "cd_ghfs": dict(method="cd_ghfs"),
    "cd_ekfs": dict(method="cd_ekfs"),
    # lascala_ghfs runs in covariance form: the sqrt-form stepped program
    # for this model faulted the first backend's device worker at B>=100
    # (cov form clean; lascala_ekfs sqrt unaffected).  Not re-tried on
    # the H100 (ROADMAP R9).  f32 cov-form NaN stragglers are handled by the
    # rescue + NaN gating.
    "lascala_ghfs": dict(method="ghfs", model="lascala", form="cov"),
    "lascala_ekfs": dict(method="ekfs", model="lascala", form="sqrt"),
    "harmonic_ekfs": dict(method="ekfs", model="harmonic",
                          num_harmonics=3, form="sqrt"),
    # harmonic CKFS: cubature sigma points on the K=3 harmonic model
    # (d=8; reference ``harmonic_ckfs_mle.py:27``).
    "harmonic_ckfs": dict(method="ghfs", model="harmonic",
                          num_harmonics=3, quadrature="cubature",
                          form="sqrt"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--methods", nargs="+", default=["ghfs"],
                    help=f"any of {sorted(METHOD_CONFIGS)} or 'all'")
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--mags", nargs="+",
                    default=["const", "damped", "random"])
    ap.add_argument("--out", default="./results")
    ap.add_argument("--form", default=None, choices=["cov", "sqrt"],
                    help="override the per-method default form")
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--max-iters", type=int, default=300)
    ap.add_argument("--stepped", action="store_true",
                    help="force the host-stepped batched L-BFGS (one short "
                         "dispatch per iteration; all magnitudes in one "
                         "batch)")
    ap.add_argument("--monolithic", action="store_true",
                    help="force the monolithic while_loop L-BFGS sweep "
                         "(one long dispatch per sweep)")
    ap.add_argument("--data-dir", default=None,
                    help="load pregenerated measurement data "
                         "(experiments/gen_toymodel_data.py) instead of "
                         "generating on-device -- guarantees bit-exact "
                         "seed pairing with the reference-regeneration "
                         "parity runs (stepped mode only)")
    args = ap.parse_args()

    if args.x64:
        jax.config.update("jax_enable_x64", True)

    # The stepped optimizer is the DEFAULT unless explicitly overridden:
    # the monolithic minutes-long while_loop dispatch failed on the first
    # backend, and is not re-established on the H100 (ROADMAP D4).
    if not args.monolithic:
        args.stepped = True

    from chirpgp_tpu.apps import (
        IFEstimationConfig, generate_rnd_keys, mc_mle_sweep,
        print_rmse_table)
    from chirpgp_tpu.apps.sweeps import save_results
    from chirpgp_tpu.parallel import make_mesh, pad_to_multiple

    methods = sorted(METHOD_CONFIGS) if args.methods == ["all"] \
        else args.methods
    keys = generate_rnd_keys(max(args.seeds, 1))[:args.seeds]

    all_results = {}
    if args.stepped:
        import functools
        import jax.numpy as jnp
        from chirpgp_tpu.apps.sweeps import (
            mle_sweep_on_measurements, toymodel_measurements)

        for method in methods:
            kwargs = dict(METHOD_CONFIGS[method])
            if args.form:
                kwargs["form"] = args.form
            cfg = IFEstimationConfig(max_iters=args.max_iters, **kwargs)
            nh = cfg.num_harmonics if cfg.model == "harmonic" else 1
            tf_parts, ys_parts = [], []
            for mag in args.mags:
                if args.data_dir:
                    import numpy as np
                    prefix = "toydata" if nh == 1 else f"toydata_h{nh}"
                    data = np.load(_os.path.join(
                        args.data_dir, f"{prefix}_{mag}.npz"))
                    ys = jnp.asarray(data["ys"][:args.seeds])
                    tf = jnp.broadcast_to(
                        jnp.asarray(data["true_freqs"]),
                        (ys.shape[0], ys.shape[1]))
                else:
                    gen = functools.partial(
                        toymodel_measurements, mag_name=mag, dt=cfg.dt,
                        T=args.T, Xi=cfg.Xi, num_harmonics=nh)
                    _, tf, ys = jax.jit(jax.vmap(gen))(keys)
                tf_parts.append(tf)
                ys_parts.append(ys)
            # Crash-recovery checkpoint: rerunning this command after an
            # interrupted sweep resumes the stepped L-BFGS from the last
            # checkpoint instead of iteration 0.
            ckpt = _os.path.join(args.out, f".ckpt_{method}.npz")
            tag = (f"{method}|T={args.T}|form={cfg.form}"
                   f"|mags={','.join(args.mags)}|seeds={args.seeds}"
                   f"|data={args.data_dir or 'gen'}")
            res = mle_sweep_on_measurements(
                cfg, jnp.concatenate(tf_parts), jnp.concatenate(ys_parts),
                checkpoint_path=ckpt, checkpoint_tag=tag, verbose=True)
            n = keys.shape[0]
            by_mag = {}
            for i, mag in enumerate(args.mags):
                r = {k: v[i * n:(i + 1) * n] for k, v in res.items()}
                path = save_results(r, method, mag, args.out)
                print(f"saved {path}", flush=True)
                by_mag[mag] = r
            all_results[method] = by_mag
            if _os.path.exists(ckpt):
                _os.remove(ckpt)
        print_rmse_table(all_results)
        return

    mesh = make_mesh()
    n_dev = mesh.devices.size
    keys, n_real = pad_to_multiple(keys, n_dev)

    for method in methods:
        kwargs = dict(METHOD_CONFIGS[method])
        if args.form:
            kwargs["form"] = args.form
        cfg = IFEstimationConfig(max_iters=args.max_iters, **kwargs)
        by_mag = {}
        for mag in args.mags:
            res = mc_mle_sweep(cfg, keys, mag, T=args.T, mesh=mesh)
            res = {k: v[:n_real] for k, v in res.items()}
            path = save_results(res, method, mag, args.out)
            print(f"saved {path}")
            by_mag[mag] = res
        all_results[method] = by_mag

    print_rmse_table(all_results)


if __name__ == "__main__":
    main()
