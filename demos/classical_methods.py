"""Classical-baseline demos on the toy chirp (counterparts of the
reference ``demos/classical_methods/{hilbert,mean_spectrogram,anf,
mle_polynomial}.py``), all JAX-native.

The FFT-based methods (Hilbert, spectrogram) need complex arithmetic,
which the first accelerator backend lacked -- this demo runs on CPU by
default (pass --accelerator to keep JAX's default platform; the ANF runs
there via its real-pair path).

Usage: python demos/classical_methods.py [--method all]
"""

# Allow running straight from a source checkout (no pip install).
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import math

import jax
import jax.numpy as jnp
import numpy as np

from chirpgp_tpu.baselines import (
    hilbert_method, mean_power_spectrum, mle_polynomial,
    adaptive_notch_filter)
from chirpgp_tpu.toymodels import (
    gen_chirp, gen_chirp_envelope, constant_mag, meow_freq)
from chirpgp_tpu.utils import rmse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="all",
                    choices=["all", "hilbert", "spectrogram", "anf", "poly"])
    ap.add_argument("--accelerator", action="store_true",
                    help="keep JAX's default platform instead of the CPU")
    args = ap.parse_args()

    if not args.accelerator:
        jax.config.update("jax_platforms", "cpu")

    dt, T, Xi = 1e-3, 3141, 0.1
    ts = jnp.linspace(dt, dt * T, T)
    freq_func, phase_func = meow_freq(offset=8.0)
    key = jax.random.PRNGKey(555)
    ys = gen_chirp(ts, constant_mag(1.0), phase_func) \
        + math.sqrt(Xi) * jax.random.normal(key, (T,))
    true_if = freq_func(ts)

    if args.method in ("all", "hilbert"):
        est = hilbert_method(ts, ys)
        err = rmse(true_if[:-1], est)
        print(f"[hilbert] IF RMSE: {float(err):.4f}")

    if args.method in ("all", "spectrogram"):
        new_ts, est = mean_power_spectrum(ts, ys)
        err = rmse(freq_func(new_ts), est)
        print(f"[spectrogram] IF RMSE: {float(err):.4f}")

    if args.method in ("all", "anf"):
        env = gen_chirp_envelope(ts, constant_mag(1.0), phase_func) \
            + math.sqrt(Xi) * jax.random.normal(jax.random.PRNGKey(3), (T,))
        # A backend without complex numbers takes the real-pair form.
        mu = 0.015
        gamma_w = mu ** 2 / 2
        gamma_alpha = mu * gamma_w / 4          # anf.py:35-37 contract
        est, _, _ = adaptive_notch_filter(ts, env, 0.0, 8.0, 0.1 + 0.0j,
                                          mu, gamma_alpha, gamma_w)
        err = rmse(true_if[1000:], est[1000:])
        print(f"[anf] IF RMSE (post-lock-in): {float(err):.4f}")

    if args.method in ("all", "poly"):
        # 7th-order polynomial IF fit (reference uses MATLAB polyfit init;
        # here: stable lstsq polyfit of the spectrogram first-moment).
        new_ts, rough = mean_power_spectrum(ts, ys)
        order = 7
        coeffs = np.polyfit(np.asarray(new_ts), np.asarray(rough), order)
        init = jnp.concatenate([jnp.array([1.0]),
                                jnp.asarray(coeffs[::-1].copy())])
        params, obj = mle_polynomial(ts, ys, Xi, init)
        from chirpgp_tpu.toymodels import polynomial_freq
        poly_if, _ = polynomial_freq(list(np.asarray(params[1:])))
        err = rmse(true_if, poly_if(ts))
        print(f"[poly-mle] IF RMSE: {float(err):.4f}")


if __name__ == "__main__":
    main()
