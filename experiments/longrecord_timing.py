"""Long-record harmonic pipeline timing: a synthetic
bat-call analog of the reference's ONLY published timing contract --
``real_applications/bats/myotis_myotis_analysis.py:81-85,109-112``, which
prints the filter+smoother wall time vs the spectrogram wall time on the
Myotis myotis call (T~25.3k samples, 4 harmonics, d=10 cubature, fixed
hand-set parameters, freq_scale=1e4).

The wav is not vendored (same blocker as the reference), so -- exactly as
the LIGO parity run (PARITY.md) -- both sides of the contract run on a
synthetic analog: a 4-harmonic FM downsweep (60->25 kHz fundamental,
Gaussian envelope) at fs=250 kHz with T=25334 samples, standardized.

Measured on the device:
  - sequential sigma-point filter+smoother wall (cov and sqrt forms),
    post warm-up, via the production ``analyze_bat_call`` path;
  - the blocked parallel-in-time iterated-SLR sigma-point pass
    (one iteration, block_size from --block) on the same model/record;
  - host spectrogram (scipy.signal) wall time + first-moment IF --
    the reference's comparison method;
  - IF-track accuracy on the envelope core (where the call has energy)
    vs the known true fundamental, for every method.

Writes a markdown report to ``--out`` (ROADMAP R3 turns this into a
benchmark cell).

Run from the repo root on the GPU:
    python experiments/longrecord_timing.py
"""

# Allow running straight from a source checkout (no pip install).
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=25334)
    ap.add_argument("--fs", type=float, default=250000.0)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--out", default="results/longrecord_timing.md")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from chirpgp_tpu.apps import MYOTIS, analyze_bat_call, standardize
    from chirpgp_tpu.apps.pipeline import IFEstimationConfig
    from chirpgp_tpu.infer.parallel_sgp import psgp_filter_smoother
    from chirpgp_tpu.quad import gaussian_expectation_1d

    T, fs = args.T, args.fs
    dt = 1.0 / fs
    ts = np.arange(T) * dt
    dur = T * dt

    # Synthetic Myotis-like call: linear FM downsweep fundamental
    # 60 -> 25 kHz, 4 harmonics with decaying amplitudes, Gaussian
    # envelope centered mid-record.
    f0, f1 = 60e3, 25e3
    freq = f0 + (f1 - f0) * ts / dur
    phase = np.cumsum(freq) * dt
    env = np.exp(-0.5 * ((ts - dur / 2) / (dur / 5)) ** 2)
    sig = sum((0.6 ** (k - 1)) * np.sin(2 * np.pi * k * phase)
              for k in range(1, MYOTIS.num_harmonics + 1))
    rng = np.random.default_rng(0)
    ys_np = env * sig + 0.01 * rng.standard_normal(T)
    ys = standardize(jnp.asarray(ys_np, dtype=jnp.float32))
    core = env > 0.5          # the energetic center of the call

    dev = jax.devices()[0]
    results = {}

    def if_rms(if_mean):
        e = np.asarray(if_mean)[core] - freq[core]
        return float(np.sqrt(np.mean(e * e)))

    # --- sequential filter+smoother, production path (both forms) ---
    for form in ("cov", "sqrt"):
        est, wall = analyze_bat_call(ys, fs, MYOTIS, form=form,
                                     time_it=True)
        results[f"seq_{form}_wall_s"] = wall
        results[f"seq_{form}_if_rms_hz"] = if_rms(est["if_mean"])

    # --- blocked parallel-in-time (iterated-SLR, one iteration) ---
    cfg = IFEstimationConfig(
        dt=dt, Xi=MYOTIS.Xi, method="ghfs", model="harmonic",
        num_harmonics=MYOTIS.num_harmonics, freq_scale=MYOTIS.freq_scale,
        quadrature="cubature", form="cov")
    pack = cfg.build(jnp.asarray(MYOTIS.params, jnp.float32))
    rule = cfg.sigma_points()
    H = pack.H.astype(jnp.float32)
    m0 = pack.m0.astype(jnp.float32)
    P0 = pack.P0.astype(jnp.float32)
    v_idx = m0.shape[0] - 2

    def psgp_blocked(ys_):
        mfs, Pfs, nll, mss, Pss = psgp_filter_smoother(
            pack.m_and_cov, rule, H, jnp.float32(MYOTIS.Xi), m0, P0,
            jnp.float32(dt), ys_, num_iters=1, block_size=args.block)
        v_mean = mss[:, v_idx]
        v_std = jnp.sqrt(jnp.maximum(Pss[:, v_idx, v_idx], 0.0))
        return gaussian_expectation_1d(v_mean, v_std) * MYOTIS.freq_scale

    run_blk = jax.jit(psgp_blocked)
    warm = run_blk(ys)
    jax.block_until_ready(warm)
    t0 = time.perf_counter()
    if_blk = run_blk(ys)
    jax.block_until_ready(if_blk)
    results["psgp_blocked_wall_s"] = time.perf_counter() - t0
    results["psgp_blocked_if_rms_hz"] = if_rms(if_blk)

    # --- host spectrogram + first-moment IF (the reference comparison,
    # myotis_myotis_analysis.py:109-112) ---
    from scipy.signal import spectrogram
    t0 = time.perf_counter()
    ff, tt, Sxx = spectrogram(np.asarray(ys), fs=fs, nperseg=256,
                              noverlap=192)
    if_spec_t = (ff[:, None] * Sxx).sum(0) / np.maximum(Sxx.sum(0), 1e-30)
    results["spectrogram_wall_s"] = time.perf_counter() - t0
    if_spec = np.interp(ts, tt, if_spec_t)
    e = if_spec[core] - freq[core]
    results["spectrogram_if_rms_hz"] = float(np.sqrt(np.mean(e * e)))

    lines = [
        "# Long-record harmonic pipeline timing (synthetic Myotis analog)",
        "",
        f"Generated {time.strftime('%Y-%m-%d %H:%M:%S UTC', time.gmtime())}"
        f" on `{dev}`.",
        "",
        f"Record: T={T} samples at fs={fs:.0f} Hz"
        f" ({MYOTIS.num_harmonics} harmonics, d={int(m0.shape[0])}"
        f" cubature = {int(rule.n_points)} sigma points, fixed Myotis"
        " hand-set params, freq_scale=1e4).  Reference timing contract:"
        " `myotis_myotis_analysis.py:81-85,109-112` (same T, model,"
        " quadrature; real wav not vendored -- synthetic analog, as the"
        " LIGO parity run).  IF-track RMS is against the known true"
        " fundamental over the envelope core (env > 0.5).",
        "",
        "| method | wall (s), post warm-up | IF-track RMS (Hz) |",
        "|---|---|---|",
        f"| seq filter+smoother (cov) | {results['seq_cov_wall_s']:.4f} |"
        f" {results['seq_cov_if_rms_hz']:.1f} |",
        f"| seq filter+smoother (sqrt) | {results['seq_sqrt_wall_s']:.4f} |"
        f" {results['seq_sqrt_if_rms_hz']:.1f} |",
        f"| blocked psgp (1 iter, block={args.block}) |"
        f" {results['psgp_blocked_wall_s']:.4f} |"
        f" {results['psgp_blocked_if_rms_hz']:.1f} |",
        f"| spectrogram + first moment (host) |"
        f" {results['spectrogram_wall_s']:.4f} |"
        f" {results['spectrogram_if_rms_hz']:.1f} |",
        "",
        f"blocked-psgp speedup vs seq cov: "
        f"{results['seq_cov_wall_s']/results['psgp_blocked_wall_s']:.2f}x;"
        f" vs seq sqrt: "
        f"{results['seq_sqrt_wall_s']/results['psgp_blocked_wall_s']:.2f}x",
    ]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"\nwritten: {args.out}")


if __name__ == "__main__":
    main()
