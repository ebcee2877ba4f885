"""Generate the float64 CPU ground truth for the parallel-in-time
checks: smoothed means of the M32 KF/RTS on a fixed chirp record
(T=3141 and T=25000), so a device run can attribute f32 error to the
sequential scan, the flat associative scan, the blocked scan and the
time-sharded scan separately (``chip_smoke.py --four`` reads it).

Writes results/data/parallel_kf_ref.npz.  Run on CPU:
    python experiments/gen_parallel_ref.py
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from chirpgp_tpu.infer import kf, rts
from chirpgp_tpu.models import m32_solution, stationary_cov_m32
from chirpgp_tpu.toymodels import gen_chirp, constant_mag, meow_freq

DT, T0, XI = 1e-3, 3141, 0.1
ts = jnp.linspace(DT, DT * T0, T0, dtype=jnp.float32)
_, phase = meow_freq(offset=8.0)
base = gen_chirp(ts, constant_mag(1.0), phase).astype(jnp.float64)

out = {}
F, Sig = m32_solution(1.0, 1.0, DT)
H = jnp.array([1.0, 0.0], jnp.float64)
P0 = stationary_cov_m32(1.0, 1.0)
m0 = jnp.zeros(2, jnp.float64)
for T in (3141, 25000):
    ys = base[:T] if T <= T0 else jnp.tile(base, (T // T0 + 1,))[:T]
    mfs, Pfs, nll = kf(F, Sig, H, XI, m0, P0, ys)
    mss, Pss = rts(F, Sig, mfs, Pfs)
    out[f"mss_T{T}"] = np.asarray(mss)
    out[f"nll_T{T}"] = np.asarray(nll[-1])
    # The exact f32 measurement sequence: device runs must consume THESE
    # bytes, not regenerate them -- device f32 transcendentals differ
    # from the CPU's, and a regenerated input puts an input-difference
    # floor under every error against this truth.
    out[f"ys_T{T}"] = np.asarray(ys, dtype=np.float32)
np.savez("results/data/parallel_kf_ref.npz", **out)
print("written results/data/parallel_kf_ref.npz",
      {k: v.shape for k, v in out.items()})
