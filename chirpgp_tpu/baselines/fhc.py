"""Fast harmonic-chirp (FHC-class) NLS estimation, JAX-native.

The reference outsources harmonic-chirp maximum-likelihood estimation to
a MATLAB implementation run on a parcluster (``tetralith/jobs/fhc.m``,
``others/README.md``); results re-enter via ``.mat`` files.  Here the
estimator is implemented in-framework: within each window the signal is
modeled as a *linear-chirp* harmonic

    y(n) = sum_{l=1..L} a_l cos(l phi(n)) + b_l sin(l phi(n)),
    phi(n) = w n + 0.5 alpha n^2,

and (w, alpha) are estimated by NLS over a 2-D grid with exact
normal-equation objectives, followed by local refinement.  The grid of
basis projections is one big batched einsum -- (n_w * n_alpha) candidates
evaluated simultaneously as batched matmuls -- and the whole tracker vmaps over
windows.
"""

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["harmonic_chirp_nls", "fhc_pitch_track", "fhc_pitch_track_batch"]


def _objective_grid(y: jnp.ndarray, ws: jnp.ndarray, alphas: jnp.ndarray,
                    L: int, ridge: float = 1e-8):
    """NLS objective J(w, alpha) on the full candidate grid.

    y: (N,); ws: (Nw,); alphas: (Na,).  Returns (Nw, Na) objective.
    """
    N = y.shape[0]
    n = jnp.arange(N, dtype=y.dtype)
    # phase (Nw, Na, N)
    phase = ws[:, None, None] * n + 0.5 * alphas[None, :, None] * n ** 2
    ls = jnp.arange(1, L + 1, dtype=y.dtype)
    ph = phase[..., None, :] * ls[:, None]          # (Nw, Na, L, N)
    C = jnp.cos(ph)
    S = jnp.sin(ph)
    Z = jnp.concatenate([C, S], axis=-2)            # (Nw, Na, 2L, N)
    v = jnp.einsum("wakn,n->wak", Z, y)             # Z^T y
    G = jnp.einsum("wakn,waln->wakl", Z, Z)         # Z^T Z (2L, 2L)
    G = G + ridge * N * jnp.eye(2 * L, dtype=y.dtype)
    sol = jnp.linalg.solve(G, v[..., None])[..., 0]
    return jnp.einsum("wak,wak->wa", v, sol)        # v^T G^{-1} v


def harmonic_chirp_nls(y: jnp.ndarray, num_harmonics: int,
                       w_bounds: Tuple[float, float],
                       alpha_bounds: Tuple[float, float] = (-2e-5, 2e-5),
                       n_w: int = 64, n_alpha: int = 15,
                       n_refine: int = 2) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Estimate (w, alpha) of a windowed harmonic linear chirp by grid NLS
    with ``n_refine`` rounds of local grid zoom.

    Returns (w, alpha) in rad/sample and rad/sample^2.  Jittable and
    vmappable over windows.
    """
    L = num_harmonics
    y = y - jnp.mean(y)

    w_lo, w_hi = w_bounds
    a_lo, a_hi = alpha_bounds

    def solve_grid(w_lo, w_hi, a_lo, a_hi):
        ws = jnp.linspace(w_lo, w_hi, n_w)
        alphas = jnp.linspace(a_lo, a_hi, n_alpha)
        J = _objective_grid(y, ws, alphas, L)
        idx = jnp.argmax(J)
        iw, ia = idx // n_alpha, idx % n_alpha
        return ws[iw], alphas[ia], (ws[1] - ws[0]), (alphas[1] - alphas[0])

    w, a, dw, da = solve_grid(w_lo, w_hi, a_lo, a_hi)
    for _ in range(n_refine):
        w, a, dw, da = solve_grid(w - dw, w + dw, a - da, a + da)
    return w, a


def fhc_pitch_track(ys, fs: float, num_harmonics: int,
                    window_length: int = 300, window_overlap: int = 295,
                    f0_bounds_hz: Tuple[float, float] = (2.0, 15.0),
                    max_chirp_rate_hz_s: float = 50.0,
                    n_w: int = 96, n_alpha: int = 11):
    """Sliding-window harmonic-chirp pitch tracking (the FHC job contract:
    per-window f0 estimates at window centres; cf. ``tetralith/jobs/
    fhc.m:15-46``).  Returns (times, f0_hz) arrays.

    The center-of-window instantaneous frequency ``w + alpha N/2`` is
    reported, matching the linear-chirp model's IF at the window centre.
    """
    ys = jnp.asarray(ys)
    T = ys.shape[0]
    dt = 1.0 / fs
    step = window_length - window_overlap
    num_windows = round((T - window_length) / step) + 1
    starts = jnp.arange(num_windows) * step
    centres = window_length / 2 + np.arange(num_windows) * step
    times = centres * dt

    w_bounds = (2 * math.pi * f0_bounds_hz[0] / fs,
                2 * math.pi * f0_bounds_hz[1] / fs)
    a_max = 2 * math.pi * max_chirp_rate_hz_s / fs ** 2
    idx = starts[:, None] + jnp.arange(window_length)[None, :]
    windows = ys[idx]                                # (W, N)

    w_centre = _solve_windows(windows, num_harmonics, w_bounds, a_max,
                              window_length, n_w, n_alpha)
    return np.asarray(times), np.asarray(w_centre) * fs / (2.0 * math.pi)


@partial(jax.jit, static_argnums=(1, 4, 5, 6))
def _solve_windows(windows, num_harmonics: int, w_bounds, a_max,
                   window_length: int, n_w: int, n_alpha: int):
    """Per-window centre-IF estimates, vmapped; jitted once per shape
    (static grid sizes) so multi-seed sweeps do not recompile.

    The reported centre IF ``w + alpha N/2`` is clipped into the f0
    search band: in sub-cycle windows (f0 * window < 1 cycle) the
    (w, alpha) pair is nearly unidentifiable and the unclipped linear
    extrapolation can leave the band entirely even though both w and
    alpha are inside their own bounds."""
    def solve(win):
        w, a = harmonic_chirp_nls(win, num_harmonics, w_bounds,
                                  (-a_max, a_max), n_w=n_w,
                                  n_alpha=n_alpha)
        return jnp.clip(w + a * window_length / 2.0,
                        w_bounds[0], w_bounds[1])

    return jax.vmap(solve)(windows)


def fhc_pitch_track_batch(yss, fs: float, num_harmonics: int,
                          window_length: int = 300,
                          window_overlap: int = 295,
                          f0_bounds_hz: Tuple[float, float] = (2.0, 15.0),
                          max_chirp_rate_hz_s: float = 50.0,
                          n_w: int = 96, n_alpha: int = 11,
                          window_chunk: int = 256):
    """Seed-batched :func:`fhc_pitch_track`: ``yss`` (B, T) -> (times (W,),
    f0_hz (B, W)).  The B * W windows are flattened and solved in
    fixed-shape chunks of ``window_chunk`` (one compile total; each
    chunk's grid projections are one einsum batch).  Chunking
    bounds the live grid tensor to
    ``window_chunk * n_w * n_alpha * 2L * window_length`` floats -- the
    full window set at Monte-Carlo scale would not fit in device memory."""
    yss = jnp.asarray(yss)
    B, T = yss.shape
    dt = 1.0 / fs
    step = window_length - window_overlap
    num_windows = round((T - window_length) / step) + 1
    starts = jnp.arange(num_windows) * step
    centres = window_length / 2 + np.arange(num_windows) * step
    times = centres * dt

    w_bounds = (2 * math.pi * f0_bounds_hz[0] / fs,
                2 * math.pi * f0_bounds_hz[1] / fs)
    a_max = 2 * math.pi * max_chirp_rate_hz_s / fs ** 2
    idx = starts[:, None] + jnp.arange(window_length)[None, :]
    windows = yss[:, idx].reshape(B * num_windows, window_length)

    total = windows.shape[0]
    out = np.empty((total,), dtype=np.asarray(yss).dtype)
    for lo in range(0, total, window_chunk):
        chunk = windows[lo:lo + window_chunk]
        n = chunk.shape[0]
        if n < window_chunk:    # pad to the compiled shape
            chunk = jnp.concatenate(
                [chunk, jnp.broadcast_to(chunk[-1:],
                                         (window_chunk - n,
                                          window_length))])
        w_centre = _solve_windows(chunk, num_harmonics, w_bounds, a_max,
                                  window_length, n_w, n_alpha)
        out[lo:lo + n] = np.asarray(w_centre)[:n]

    f0 = out.reshape(B, num_windows) * fs / (2.0 * math.pi)
    return np.asarray(times), f0
