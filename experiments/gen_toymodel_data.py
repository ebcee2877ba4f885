"""Pregenerate the paired toymodel measurement data shared by BOTH the
device sweeps and the reference-regeneration parity runs.

The paper's Table I is a *paired* comparison: every method sees the same
100 measurement realizations (reference ``tetralith/rnd_keys.npy`` +
per-job in-line data gen, ``jobs/ghfs_mle.py:26-47``).  The vendored key
file was produced by an older JAX whose ``random.split`` derivation
differs from the current one, so exact key-array parity is impossible;
instead this repo fixes the pairing contract at the DATA level: generate
once in float32 (the device operating precision) and have both the
device sweeps and the reference-code regeneration consume the same
arrays.

Writes ``{out}/toydata_{mag}.npz`` with ys (N, T) f32, true_freqs (T,),
ts (T,), and the key array used.

Usage:
    python experiments/gen_toymodel_data.py --seeds 100 --out results/data
"""

# Allow running straight from a source checkout (no pip install).
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--num-harmonics", type=int, default=1)
    ap.add_argument("--out", default="./results/data")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import functools

    import jax.numpy as jnp

    from chirpgp_tpu.apps.sweeps import (
        generate_rnd_keys, toymodel_measurements)

    keys = generate_rnd_keys(max(args.seeds, 1))[:args.seeds]
    os.makedirs(args.out, exist_ok=True)
    prefix = ("toydata" if args.num_harmonics == 1
              else f"toydata_h{args.num_harmonics}")
    for mag in ("const", "damped", "random"):
        gen = functools.partial(
            toymodel_measurements, mag_name=mag, dt=1e-3, T=args.T,
            Xi=0.1, num_harmonics=args.num_harmonics)
        ts, tf, ys = jax.jit(jax.vmap(gen))(keys)
        path = os.path.join(args.out, f"{prefix}_{mag}.npz")
        np.savez(path, ys=np.asarray(ys, np.float32),
                 true_freqs=np.asarray(tf[0], np.float32),
                 ts=np.asarray(ts[0], np.float32),
                 keys=np.asarray(keys))
        print(f"saved {path} ys{ys.shape}")


if __name__ == "__main__":
    main()
