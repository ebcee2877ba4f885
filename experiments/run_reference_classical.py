"""Regenerate the REFERENCE's classical-baseline Table-I numbers.

Sibling of ``run_reference_regen.py`` for the non-SSM columns: runs the
reference package's own classical estimators (``/root/reference/chirpgp/
classical_methods.py``, CPU, float64) under the exact job protocols of
``tetralith/jobs/{hilbert,mean_spectrogram,mle_polynomial,anf}.py``,
with the same pregenerated keys (PRNGKey(999) split 1000,
``tetralith/generate_rndkeys.py:8-12``), so every column is seed-paired
with the repo's classical sweeps.

The two remaining classical columns CANNOT be regenerated here by
construction (documented in PARITY.md):

- ``fastf0nls``: the reference calls an external ``single_pitch.so``
  that is not vendored ("due to their licences ... download ...
  yourself", ``others/README.md:11``) and there is no network egress.
- ``fhc``: the reference's FHC estimator is a MATLAB toolbox driven by
  ``tetralith/jobs/fhc.m``; MATLAB is not available in this image.

Results: ``{out}/{method}_{mag}.npz`` with per-seed rmse (+ estimates
where cheap), written incrementally (resume-safe).

Usage:
    python experiments/run_reference_classical.py --methods hilbert poly
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

import numpy as np

from run_reference_regen import _install_shims, REFERENCE_ROOT


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--methods", nargs="+",
                    default=["hilbert", "spectrogram", "anf", "poly"],
                    choices=["hilbert", "spectrogram", "anf", "poly"])
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--mags", nargs="+",
                    default=["const", "damped", "random"])
    ap.add_argument("--out", default="./results/reference")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    _install_shims()
    sys.path.insert(0, REFERENCE_ROOT)

    import jax.numpy as jnp
    import scipy.signal

    import chirpgp.tools
    from chirpgp.classical_methods import (
        hilbert_method, mean_power_spectrum, mle_polynomial,
        adaptive_notch_filter)
    from chirpgp.toymodels import (
        gen_chirp, gen_chirp_envelope, meow_freq, constant_mag,
        damped_exp_mag, random_ou_mag)

    dt, T, Xi = 1e-3, 3141, 0.1
    fs = 1.0 / dt
    ts = jnp.linspace(dt, dt * T, T)
    true_freq_func, true_phase_func = meow_freq(offset=8.0)
    keys = jax.random.split(jax.random.PRNGKey(999), 1000)

    # Butterworth pre-filter shared by hilbert + spectrogram
    # (``tetralith/jobs/hilbert.py:35-36``).
    sos = scipy.signal.butter(N=8, Wn=18, btype="lowpass", analog=False,
                              fs=fs, output="sos")

    # mle_polynomial init (``tetralith/jobs/mle_polynomial.py:35-41``).
    poly_coeffs0 = jnp.array([
        1., 7.791782e+00, 5.488218e+00, -2.723514e+01, 9.018465e+00,
        1.431405e+02, -2.483806e+02, 1.738925e+02, -6.028065e+01,
        1.003177e+01, -5.527010e-01, -1.907047e-02])
    poly_perb = poly_coeffs0 * 2e-5
    poly_init = poly_coeffs0 + poly_perb * jax.random.normal(
        jax.random.PRNGKey(666), shape=poly_coeffs0.shape)

    def measurements(mc, mag_name, envelope):
        key = keys[mc]
        key_meas, key_ou = jax.random.split(key)
        mag = {"const": lambda: constant_mag(1.0),
               "damped": lambda: damped_exp_mag(0.3),
               "random": lambda: random_ou_mag(1.0, 1.0, key_ou)}[mag_name]()
        gen = gen_chirp_envelope if envelope else gen_chirp
        chirp = (gen(ts, mag, true_phase_func, 0.0) if envelope
                 else gen(ts, mag, true_phase_func))
        return chirp + math.sqrt(Xi) * jax.random.normal(
            key_meas, shape=(ts.size,))

    def run_hilbert(mc, mag_name):
        ys = measurements(mc, mag_name, envelope=False)
        filtered = scipy.signal.sosfiltfilt(sos, ys)
        est = hilbert_method(ts, filtered)
        return float(chirpgp.tools.rmse(true_freq_func(ts)[1:], est))

    def run_spectrogram(mc, mag_name):
        ys = measurements(mc, mag_name, envelope=False)
        filtered = scipy.signal.sosfiltfilt(sos, ys)
        seg_ts, est = mean_power_spectrum(ts, filtered, window="cosine",
                                          nperseg=450, noverlap=449)
        return float(chirpgp.tools.rmse(true_freq_func(seg_ts), est))

    def run_poly(mc, mag_name):
        ys = measurements(mc, mag_name, envelope=False)
        coeffs, _ = mle_polynomial(ts, ys, Xi, poly_init,
                                   method="levenberg_marquardt",
                                   lr=0.4, nu=0.3)
        est = jnp.polyval(jnp.flip(coeffs[1:]), ts)
        return float(chirpgp.tools.rmse(true_freq_func(ts), est))

    def run_anf(mc, mag_name):
        ys = measurements(mc, mag_name, envelope=True)
        mu = 0.015
        gamma_w = mu ** 2 / 2
        gamma_alpha = mu * gamma_w / 4
        est, _, _ = adaptive_notch_filter(
            ts, ys, alpha0=0.0, w0=true_freq_func(dt), s0=1 + 0.j,
            mu=mu, gamma_alpha=gamma_alpha, gamma_w=gamma_w)
        return float(chirpgp.tools.rmse(true_freq_func(ts), est))

    runners = {"hilbert": run_hilbert, "spectrogram": run_spectrogram,
               "poly": run_poly, "anf": run_anf}

    os.makedirs(args.out, exist_ok=True)
    for method in args.methods:
        run = runners[method]
        for mag in args.mags:
            out_path = os.path.join(args.out, f"{method}_{mag}.npz")
            if os.path.exists(out_path):
                rmses = list(np.load(out_path)["rmse"])
            else:
                rmses = []
            for mc in range(len(rmses), args.seeds):
                t0 = time.time()
                try:
                    r = run(mc, mag)
                except Exception as e:   # record divergence, keep sweep
                    print(f"[{method} {mag}] seed {mc} FAILED: {e}",
                          flush=True)
                    r = float("nan")
                rmses.append(r)
                np.savez(out_path, rmse=np.asarray(rmses))
                print(f"[{method} {mag}] seed {mc}: rmse={r:.4f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            r = np.asarray(rmses) * 10
            ok = r[~np.isnan(r)]
            print(f"== {method} {mag}: mean {ok.mean():.3f}+-{ok.std():.3f}"
                  f" median {np.median(ok):.3f} min {ok.min():.3f} "
                  f"nan {int(np.isnan(r).sum())}", flush=True)


if __name__ == "__main__":
    main()
