"""Classical (non-state-space) IF estimators.

Reference: ``chirpgp/classical_methods.py``.  Unlike the reference, which
drops to host scipy.signal for the Hilbert transform and spectrogram
("Most of the scipy.signal functions are not supported by jax",
``classical_methods.py:26``), all four methods here are pure JAX -- FFT
and framing run on the device and the estimators are jittable and vmappable
over Monte-Carlo seeds.
"""

import math
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from chirpgp_tpu.toymodels import gen_chirp
from chirpgp_tpu.fit.gauss_newton import (
    gauss_newton, levenberg_marquardt, gauss_newton_while,
    levenberg_marquardt_while)

__all__ = ["hilbert_transform", "hilbert_method", "mean_power_spectrum",
           "mle_polynomial", "mle_polynomial_batched",
           "adaptive_notch_filter", "tukey_window", "butter_lowpass"]


def butter_lowpass(ys, cutoff_hz: float, fs: float, order: int = 8):
    """Zero-phase Butterworth lowpass (host scipy): the pre-filter the
    reference's Hilbert/spectrogram demos apply before estimation
    (``demos/classical_methods/hilbert.py:37-38``)."""
    import numpy as np
    import scipy.signal
    b, a = scipy.signal.butter(order, cutoff_hz, fs=fs, btype="low")
    return jnp.asarray(scipy.signal.filtfilt(b, a, np.asarray(ys)))


def hilbert_transform(ys: jnp.ndarray) -> jnp.ndarray:
    """Analytic signal via FFT (JAX-native equivalent of
    ``scipy.signal.hilbert``)."""
    n = ys.shape[-1]
    X = jnp.fft.fft(ys)
    h = jnp.zeros(n)
    if n % 2 == 0:
        h = h.at[0].set(1.0).at[n // 2].set(1.0).at[1:n // 2].set(2.0)
    else:
        h = h.at[0].set(1.0).at[1:(n + 1) // 2].set(2.0)
    return jnp.fft.ifft(X * h)


def hilbert_method(ts: jnp.ndarray, ys: jnp.ndarray) -> jnp.ndarray:
    """IF from the phase derivative of the analytic signal (reference
    ``classical_methods.py:48-86``).  Returns T-1 values."""
    fs = 1.0 / (ts[1] - ts[0])
    analytic = hilbert_transform(ys)
    phase = jnp.unwrap(jnp.angle(analytic))
    return jnp.diff(phase) / (2.0 * math.pi) * fs


def tukey_window(n: int, alpha: float = 0.25) -> jnp.ndarray:
    """Tukey (tapered cosine) window, matching ``scipy.signal.windows.tukey``
    (the default spectrogram window)."""
    if alpha <= 0:
        return jnp.ones(n)
    x = jnp.linspace(0.0, 1.0, n)
    w = jnp.ones(n)
    edge = alpha / 2.0
    left = x < edge
    right = x >= 1.0 - edge
    w = jnp.where(left, 0.5 * (1.0 + jnp.cos(math.pi * (2.0 * x / alpha - 1.0))), w)
    w = jnp.where(right, 0.5 * (1.0 + jnp.cos(math.pi * (2.0 * x / alpha - 2.0 / alpha + 1.0))), w)
    return w


def cosine_window(n: int) -> jnp.ndarray:
    """Cosine (half-sine) window, matching
    ``scipy.signal.windows.cosine`` (the reference spectrogram job's
    window, ``tetralith/jobs/mean_spectrogram.py:39``)."""
    return jnp.sin(math.pi / n * (jnp.arange(n) + 0.5))


def _stft_psd(ys: jnp.ndarray, fs: float, nperseg: int, noverlap: int,
              window: str = "tukey"):
    """One-sided PSD spectrogram with constant detrend and density scaling,
    matching ``scipy.signal.spectrogram`` defaults."""
    step = nperseg - noverlap
    n_frames = 1 + (ys.shape[-1] - nperseg) // step
    idx = jnp.arange(n_frames)[:, None] * step + jnp.arange(nperseg)[None, :]
    frames = ys[idx]                                     # (F, nperseg)
    frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
    win = cosine_window(nperseg) if window == "cosine" \
        else tukey_window(nperseg)
    spec = jnp.fft.rfft(frames * win, axis=-1)           # (F, nfreq)
    scale = 1.0 / (fs * jnp.sum(win ** 2))
    psd = (spec.real ** 2 + spec.imag ** 2) * scale
    # One-sided doubling (except DC and Nyquist for even nperseg).
    nfreq = psd.shape[-1]
    mult = jnp.ones(nfreq).at[1:].set(2.0)
    if nperseg % 2 == 0:
        mult = mult.at[-1].set(1.0)
    psd = psd * mult
    freqs = jnp.fft.rfftfreq(nperseg, d=1.0 / fs)
    times = (jnp.arange(n_frames) * step + nperseg / 2.0) / fs
    return freqs, times, psd.T                            # psd (nfreq, F)


def mean_power_spectrum(ts: jnp.ndarray, ys: jnp.ndarray,
                        nperseg: int = 256,
                        noverlap: Optional[int] = None,
                        window: str = "tukey") -> Tuple[jnp.ndarray, jnp.ndarray]:
    """IF as the first moment of the spectrogram PSD (reference
    ``classical_methods.py:89-116``); JAX-native STFT."""
    if noverlap is None:
        noverlap = nperseg // 8
    fs = 1.0 / (ts[1] - ts[0])
    freqs, times, Sxx = _stft_psd(ys, fs, nperseg, noverlap, window)
    est = jnp.sum(freqs[:, None] * Sxx, axis=0) / jnp.sum(Sxx, axis=0)
    return times + ts[0], est


def _poly_chirp_fn(ts: jnp.ndarray, num_params: int) -> Callable:
    """params = [alpha, c_0..c_n] -> alpha * sin(2 pi zeta(t)) with
    zeta the antiderivative of the IF polynomial sum c_k t^k."""
    n = num_params - 2
    if n < 0:
        raise ValueError("init_params must have at least 2 entries.")
    alien = jnp.array([1.0 / (j + 1) for j in range(n + 1)])

    def zeta(t, cs):
        coeffs = jnp.concatenate([jnp.zeros(1), alien * cs])
        return jnp.polyval(jnp.flip(coeffs), t)

    def f(params):
        alpha = params[0]
        cs = params[1:]
        return gen_chirp(ts, lambda _: alpha, lambda u: zeta(u, cs), 0.0)

    return f


def mle_polynomial_batched(ts: jnp.ndarray, yss: jnp.ndarray, Xi,
                           init_params: jnp.ndarray,
                           method: str = "levenberg_marquardt",
                           max_iters: int = 100):
    """Monte-Carlo-batched polynomial MLE: one jitted/vmapped
    ``lax.while_loop`` LM (or GN) program over a batch of measurement
    sequences ``yss`` (B, T) with per-seed inits ``init_params`` (B, P).
    All seeds advance in lockstep; returns a batched
    :class:`~chirpgp_tpu.fit.gauss_newton.NLSResult`.

    Replaces the reference's per-seed host loop
    (``tetralith/jobs/mle_polynomial.py``) with a single XLA program.
    """
    f = _poly_chirp_fn(ts, init_params.shape[-1])
    solver = (gauss_newton_while if method == "gauss_newton"
              else levenberg_marquardt_while)

    def one(p0, ys):
        return solver(f, p0, ys, Xi, max_iters=max_iters)

    return jax.jit(jax.vmap(one))(init_params, yss)


def mle_polynomial(ts: jnp.ndarray, ys: jnp.ndarray, Xi,
                   init_params: jnp.ndarray,
                   method: str = "levenberg_marquardt",
                   *args, **kwargs) -> Tuple[jnp.ndarray, jnp.ndarray]:
    r"""MLE of a polynomial-IF chirp ``y = alpha sin(2 pi zeta(t))``
    (reference ``classical_methods.py:119-193``).

    ``init_params = [alpha, c_0, ..., c_n]`` with the IF polynomial
    ``f(t) = sum c_k t^k`` and phase ``zeta(t) = sum c_k t^{k+1}/(k+1)``.
    """
    f = _poly_chirp_fn(ts, init_params.shape[0])

    if method == "gauss_newton":
        return gauss_newton(f, init_params, ys, Xi, *args, **kwargs)
    if method == "levenberg_marquardt":
        return levenberg_marquardt(f, init_params, ys, Xi, *args, **kwargs)
    if method == "L-BFGS-B":
        from chirpgp_tpu.fit.mle import scipy_minimize

        def obj(params):
            return jnp.sum((ys - f(params)) ** 2) / Xi

        res = scipy_minimize(obj, init_params)
        return res.params, res.fun_val
    raise ValueError(f"Method {method!r} does not exist.")


def adaptive_notch_filter(ts: jnp.ndarray, ys: jnp.ndarray,
                          alpha0: float, w0: float, s0: complex,
                          mu: float, gamma_alpha: float,
                          gamma_w: float) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pilot adaptive notch filter of Niedzwiecki & Meller 2011, Table II
    (reference ``classical_methods.py:196-254``).  ``ys`` is the complex
    chirp envelope, either as a complex array or as a real ``(T, 2)``
    array of (real, imag) -- the form for backends without complex
    arithmetic (the recursion is carried in real pairs either way).  Parameters should satisfy ``gamma_alpha << gamma_w << mu < 1``.
    """
    dt = ts[1] - ts[0]

    complex_in = jnp.iscomplexobj(ys)
    if complex_in:
        y_pairs = jnp.stack([jnp.real(ys), jnp.imag(ys)], axis=-1)
    else:
        y_pairs = ys
    s0 = complex(s0)

    def step(carry, y):
        w, alpha, sr, si = carry
        theta = 2.0 * math.pi * (w + alpha)
        c, sn = jnp.cos(theta), jnp.sin(theta)
        # rot * s
        a = c * sr - sn * si
        b = sn * sr + c * si
        er = y[0] - a
        ei = y[1] - b
        # Im(eps * conj(rot) * conj(s)) = Im((er + i ei)(a - i b))
        delta = (ei * a - er * b) / (sr ** 2 + si ** 2)
        sr_new = a + mu * er
        si_new = b + mu * ei
        w = w + alpha + gamma_w * delta
        alpha = alpha + gamma_alpha * delta
        return (w, alpha, sr_new, si_new), (w, alpha, sr_new, si_new)

    init = (jnp.asarray(w0 * dt), jnp.asarray(alpha0 * dt),
            jnp.asarray(s0.real, y_pairs.dtype),
            jnp.asarray(s0.imag, y_pairs.dtype))
    _, (freqs, alphas, srs, sis) = jax.lax.scan(step, init, y_pairs)
    if complex_in:
        mags = srs + 1.0j * sis
    else:
        mags = jnp.stack([srs, sis], axis=-1)
    return freqs / dt, alphas / dt, mags
