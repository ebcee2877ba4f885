"""chirpgp_tpu: an accelerator-native Bayesian chirp / instantaneous-frequency
estimation framework.

A ground-up JAX/XLA re-design with the capabilities of the reference
``spdes/chirpgp`` package (probabilistic IF estimation of chirp signals via
SDE state-space priors and Gaussian filters/smoothers; see
arXiv:2205.06306), run on an NVIDIA GPU:

- batched moment maps so sigma-point propagation runs as fused einsums,
- state-independent process covariances exploited (no per-point cov reduce),
- square-root (Cholesky) filter forms for float32 numerics,
- associative-scan (parallel-in-time) Kalman filtering/smoothing,
- in-JAX L-BFGS so hyperparameter MLE jits end-to-end,
- ``shard_map`` Monte-Carlo sweeps over device meshes.

Subpackages
-----------
quad       sigma-point rules, RK4 moment integrators, Gaussian expectations
models     SDE priors (chirp / harmonic chirp / La Scala / Matern-3/2 / KPT)
           and their discretizations (LCD closed form, exact LTI, TME)
infer      filters and smoothers (KF/RTS, EKF/EKS, SGP, CD variants,
           associative-scan parallel forms)
fit        hyperparameter estimation (in-JAX L-BFGS MLE, Gauss-Newton, LM)
parallel   mesh/sharding utilities for Monte-Carlo sweeps
utils      LTI discretization, simulators, metrics
ops        native (C++) ops
baselines  classical IF estimators (Hilbert, spectrogram, poly-MLE, ANF)
apps       end-to-end pipelines (toymodel demos, bats, LIGO)
"""

import os as _os

import jax as _jax

# Full float32 matmuls by default.  On an H100, XLA's "default" and
# "high" precisions let float32 products run in TF32 (10-bit mantissa);
# for this framework's small sequential filter algebra the ~1e-3
# relative rounding per product accumulates over T~3e3 scan steps.
# experiments/check_precision_policy.py on an NVIDIA H100 80GB HBM3
# (400 W power limit), one record at T=3141, d=4: the float32 filter NLL
# is 1.5% ("default") and 1.9% ("high") off its float64 value and its
# gradient 9.6% and 12% off, against 1.4e-5 and 8.8e-5 under "highest".
# The CKFS seed-0 gate alone (0.776 at all three settings) does not show
# it.  chip_smoke.py's bounds hold the batched estimates and fits to it.
# Override with CHIRPGP_TPU_MATMUL_PRECISION=default|high|highest.
_jax.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("CHIRPGP_TPU_MATMUL_PRECISION", "highest"))

# Persistent compilation cache, shared by every runner (sweeps, bench,
# demos).  JAX reads JAX_COMPILATION_CACHE_DIR itself; only when it is
# unset does the cache go to one fixed directory of the checkout (a
# fixed path, because the path is part of the cache key).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from chirpgp_tpu import quad, models, infer, utils

__version__ = "0.1.0"
