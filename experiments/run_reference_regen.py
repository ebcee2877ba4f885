"""Regenerate the REFERENCE's own Table-I numbers for parity.

BASELINE.md defines parity against *regenerated* reference results: the
reference publishes no numbers, only the machinery.  This driver runs the
reference code itself (``/root/reference/chirpgp``, CPU, float64, SciPy
L-BFGS-B -- the exact ``tetralith/jobs/*_mle.py`` semantics) over the SAME
pregenerated measurement data the device sweeps consume
(``experiments/gen_toymodel_data.py``), so the comparison is seed-paired.

Two environment shims are installed before importing the reference package
(neither is on this host and neither affects the executed math):

- ``tme``: imported at ``chirpgp/models.py:24`` but only used by the
  TME discretization, which no Table-I job calls -> stub module.
- ``jaxopt.ScipyMinimize``: thin reimplementation over
  ``scipy.optimize.minimize`` with a jitted value-and-grad, matching
  jaxopt's contract (jit=True, L-BFGS-B, ``state.success``).

Results: ``{out}/{method}_{mag}.npz`` with per-seed rmse / params /
success, written incrementally (resume-safe).

Usage:
    python experiments/run_reference_regen.py --method ekfs --seeds 100
"""

# Allow running straight from a source checkout (no pip install).
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import math
import os
import sys
import time
import types

import numpy as np

REFERENCE_ROOT = "/root/reference"


def _install_shims():
    # tme stub: chirpgp/models.py imports it at module top; only
    # disc_chirp_tme (unused by the Table-I jobs) calls into it.
    if "tme" not in sys.modules:
        stub = types.ModuleType("tme")
        stub.__path__ = []  # mark as package for `import tme.base_jax`
        sub = types.ModuleType("tme.base_jax")

        def _unavailable(*a, **k):
            raise NotImplementedError(
                "tme package not available in this environment; the "
                "Table-I reference jobs do not use the TME discretization")

        sub.mean_and_cov = _unavailable
        stub.base_jax = sub
        sys.modules["tme"] = stub
        sys.modules["tme.base_jax"] = sub

    # Minimal jaxopt.ScipyMinimize with the contract the reference jobs
    # rely on: .run(init) -> (params, state), state.success from scipy.
    if "jaxopt" not in sys.modules:
        import jax
        import jax.numpy as jnp
        from scipy.optimize import minimize

        class _State:
            def __init__(self, res):
                self.success = bool(res.success)
                self.fun_val = float(res.fun)
                self.iter_num = int(res.nit)

            def __repr__(self):
                return (f"ScipyMinimizeInfo(success={self.success}, "
                        f"fun_val={self.fun_val:.6f}, "
                        f"iter_num={self.iter_num})")

        class ScipyMinimize:
            def __init__(self, method="L-BFGS-B", jit=True, fun=None,
                         **kw):
                self.method = method
                self.fun = fun
                self._vg = jax.jit(jax.value_and_grad(fun)) if jit \
                    else jax.value_and_grad(fun)

            def run(self, init_params):
                def f_np(x):
                    v, g = self._vg(jnp.asarray(x))
                    return float(v), np.asarray(g, dtype=np.float64)

                res = minimize(f_np,
                               np.asarray(init_params, dtype=np.float64),
                               method=self.method, jac=True)
                return jnp.asarray(res.x), _State(res)

        mod = types.ModuleType("jaxopt")
        mod.ScipyMinimize = ScipyMinimize
        sys.modules["jaxopt"] = mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", required=True,
                    choices=["ghfs", "ekfs", "ckfs", "cd_ghfs", "cd_ekfs",
                             "lascala_ghfs", "lascala_ekfs", "kpt",
                             "harmonic_ekfs", "harmonic_ckfs",
                             "harmonic_kpt"])
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--mags", nargs="+",
                    default=["const", "damped", "random"])
    ap.add_argument("--data-dir", default="./results/data")
    ap.add_argument("--out", default="./results/reference")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    _install_shims()
    sys.path.insert(0, REFERENCE_ROOT)

    import jax.numpy as jnp
    import jaxopt  # the shim

    import chirpgp.tools
    from chirpgp.filters_smoothers import (
        ekf, eks, ekf_for_kpt, rts, sgp_filter, sgp_smoother,
        cd_ekf, cd_eks, cd_sgp_filter, cd_sgp_smoother)
    from chirpgp.models import (
        g, g_inv, build_chirp_model, build_harmonic_chirp_model,
        build_lascala_model, build_kpt_chirp_model)
    from chirpgp.quadratures import SigmaPoints, gaussian_expectation

    method = args.method
    dt, fs = 1e-3, 1e3
    Xi = 0.1
    harmonic = method.startswith("harmonic")
    num_harmonics = 3 if harmonic else 1
    d = 2 * num_harmonics + 2

    # --- per-method model/filter/smoother/init wiring (the exact job
    # semantics of tetralith/jobs/{method}_mle.py) ---
    if method in ("ghfs", "ckfs", "harmonic_ckfs"):
        sgps = (SigmaPoints.gauss_hermite(d=4, order=3)
                if method == "ghfs" else SigmaPoints.cubature(d=d))
        build = (build_chirp_model if not harmonic else
                 (lambda p: build_harmonic_chirp_model(
                     p, num_harmonics=num_harmonics)))
        init_theta = g_inv(jnp.array([0.1, 0.1, 0.1, 1., 1., 7.]))

        def make_obj(ys):
            def obj(theta):
                _, _, mc_, m0, P0, H = build(g(theta))
                return sgp_filter(mc_, sgps, H, Xi, m0, P0, dt, ys)[-1][-1]
            return obj

        def smooth_if(params, ys):
            _, _, mc_, m0, P0, H = build(params)
            mfs, Pfs, _ = sgp_filter(mc_, sgps, H, Xi, m0, P0, dt, ys)
            mss, Pss = sgp_smoother(mc_, sgps, mfs, Pfs, dt)
            vi = -2 if harmonic else 2
            return gaussian_expectation(
                ms=mss[:, vi], chol_Ps=jnp.sqrt(Pss[:, vi, vi]), func=g,
                force_shape=True)[:, 0]

    elif method in ("ekfs", "harmonic_ekfs"):
        build = (build_chirp_model if not harmonic else
                 (lambda p: build_harmonic_chirp_model(
                     p, num_harmonics=num_harmonics)))
        init_theta = g_inv(jnp.array([0.1, 0.1, 0.1, 1., 1., 7.]))

        def make_obj(ys):
            def obj(theta):
                _, _, mc_, m0, P0, H = build(g(theta))
                return ekf(mc_, H, Xi, m0, P0, dt, ys)[-1][-1]
            return obj

        def smooth_if(params, ys):
            _, _, mc_, m0, P0, H = build(params)
            mfs, Pfs, _ = ekf(mc_, H, Xi, m0, P0, dt, ys)
            mss, Pss = eks(mc_, mfs, Pfs, dt)
            vi = -2 if harmonic else 2
            return gaussian_expectation(
                ms=mss[:, vi], chol_Ps=jnp.sqrt(Pss[:, vi, vi]), func=g,
                force_shape=True)[:, 0]

    elif method in ("lascala_ghfs", "lascala_ekfs"):
        sgps = SigmaPoints.gauss_hermite(d=4, order=3) \
            if method.endswith("ghfs") else None
        init_theta = g_inv(jnp.array([0.1, 1., 1., 7.]))

        def make_obj(ys):
            def obj(theta):
                _, _, mc_, m0, P0, H = build_lascala_model(g(theta))
                if sgps is None:
                    return ekf(mc_, H, Xi, m0, P0, dt, ys)[-1][-1]
                return sgp_filter(mc_, sgps, H, Xi, m0, P0, dt, ys)[-1][-1]
            return obj

        def smooth_if(params, ys):
            _, _, mc_, m0, P0, H = build_lascala_model(params)
            if sgps is None:
                mfs, Pfs, _ = ekf(mc_, H, Xi, m0, P0, dt, ys)
                mss, Pss = eks(mc_, mfs, Pfs, dt)
            else:
                mfs, Pfs, _ = sgp_filter(mc_, sgps, H, Xi, m0, P0, dt, ys)
                mss, Pss = sgp_smoother(mc_, sgps, mfs, Pfs, dt)
            return gaussian_expectation(
                ms=mss[:, 2], chol_Ps=jnp.sqrt(Pss[:, 2, 2]), func=g,
                force_shape=True)[:, 0]

    elif method in ("cd_ghfs", "cd_ekfs"):
        sgps = SigmaPoints.gauss_hermite(d=4, order=3) \
            if method == "cd_ghfs" else None
        init_theta = g_inv(jnp.array([0.1, 0.1, 0.1, 1., 1., 7.]))

        def make_obj(ys):
            def obj(theta):
                drift, disp, _, m0, P0, H = build_chirp_model(g(theta))
                if sgps is None:
                    return cd_ekf(drift, disp, H, Xi, m0, P0, dt,
                                  ys)[-1][-1]
                return cd_sgp_filter(drift, disp(jnp.eye(4)), sgps, H, Xi,
                                     m0, P0, dt, ys)[-1][-1]
            return obj

        def smooth_if(params, ys):
            drift, disp, _, m0, P0, H = build_chirp_model(params)
            if sgps is None:
                mfs, Pfs, _ = cd_ekf(drift, disp, H, Xi, m0, P0, dt, ys)
                mss, Pss = cd_eks(drift, disp, mfs, Pfs, dt)
            else:
                b = disp(jnp.eye(4))
                mfs, Pfs, _ = cd_sgp_filter(drift, b, sgps, H, Xi, m0, P0,
                                            dt, ys)
                mss, Pss = cd_sgp_smoother(drift, b, sgps, mfs, Pfs, dt)
            return gaussian_expectation(
                ms=mss[:, 2], chol_Ps=jnp.sqrt(Pss[:, 2, 2]), func=g,
                force_shape=True)[:, 0]

    elif method in ("kpt", "harmonic_kpt"):
        init_theta = g_inv(jnp.array([0.02, 1e-5, 1e-5, 8., 1.]))

        def make_obj(ys):
            def obj(theta):
                F, Sig, m0, P0, h = build_kpt_chirp_model(
                    g(theta), fs, num_harmonics=num_harmonics)
                return ekf_for_kpt(F, Sig, h, Xi, m0, P0, dt, ys)[-1][-1]
            return obj

        def smooth_if(params, ys):
            F, Sig, m0, P0, h = build_kpt_chirp_model(
                params, fs, num_harmonics=num_harmonics)
            mfs, Pfs, _ = ekf_for_kpt(F, Sig, h, Xi, m0, P0, dt, ys)
            mss, Pss = rts(F, Sig, mfs, Pfs)
            scale = fs / 2 / math.pi
            return gaussian_expectation(
                ms=mss[:, 0] * scale,
                chol_Ps=jnp.sqrt(Pss[:, 0, 0]) * scale, func=g,
                force_shape=True)[:, 0]
    else:
        raise ValueError(method)

    os.makedirs(args.out, exist_ok=True)
    prefix = "toydata" if not harmonic else f"toydata_h{num_harmonics}"

    for mag in args.mags:
        data = np.load(os.path.join(args.data_dir, f"{prefix}_{mag}.npz"))
        yss = jnp.asarray(data["ys"], dtype=jnp.float64)[:args.seeds]
        ts = jnp.asarray(data["ts"], dtype=jnp.float64)
        true_freqs = jnp.asarray(data["true_freqs"], dtype=jnp.float64)

        out_path = os.path.join(args.out, f"{method}_{mag}.npz")
        if os.path.exists(out_path):
            prev = np.load(out_path)
            rmses = list(prev["rmse"])
            params_list = list(prev["params"])
            succ = list(prev["success"])
        else:
            rmses, params_list, succ = [], [], []

        for mc in range(len(rmses), args.seeds):
            t0 = time.time()
            ys = yss[mc]
            solver = jaxopt.ScipyMinimize(method="L-BFGS-B", jit=True,
                                          fun=make_obj(ys))
            opt_vals, opt_state = solver.run(init_theta)
            opt_params = g(opt_vals)
            if opt_state.success:
                if_mean = smooth_if(opt_params, ys)
                r = float(chirpgp.tools.rmse(true_freqs, if_mean))
            else:
                r = float("nan")
            rmses.append(r)
            params_list.append(np.asarray(opt_params))
            succ.append(opt_state.success)
            np.savez(out_path, rmse=np.asarray(rmses),
                     params=np.asarray(params_list),
                     success=np.asarray(succ))
            print(f"[{method} {mag}] seed {mc}: rmse={r:.4f} "
                  f"({time.time() - t0:.1f}s, "
                  f"iters={opt_state.iter_num})", flush=True)
            # Every seed's objective closes over its own ys (the
            # reference job structure), so each seed compiles a fresh
            # XLA program; without clearing, the jit cache grows
            # unbounded and long regens die with LLVM "Cannot allocate
            # memory" (observed at ~260 accumulated seeds on cd_ghfs).
            jax.clear_caches()

        r = np.asarray(rmses) * 10
        ok = r[~np.isnan(r)]
        print(f"== {method} {mag}: mean {ok.mean():.3f}+-{ok.std():.3f} "
              f"median {np.median(ok):.3f} min {ok.min():.3f} "
              f"nan {int(np.isnan(r).sum())}", flush=True)


if __name__ == "__main__":
    main()
