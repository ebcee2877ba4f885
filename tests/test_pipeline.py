"""End-to-end minimum-slice test (SURVEY.md 7): toy chirp data -> chirp
model -> GHFS filter/smoother -> in-JAX L-BFGS MLE -> IF posterior ->
RMSE.  Short sequence for CI speed; full-scale parity runs live in
``demos/`` and the benchmark harness."""

import math

import jax
import jax.numpy as jnp
import numpy.testing as npt
import pytest

from chirpgp_tpu.apps import IFEstimationConfig, run_pipeline, estimate_if, fit_mle
from chirpgp_tpu.models import g, g_inv
from chirpgp_tpu.toymodels import gen_chirp, constant_mag, meow_freq
from chirpgp_tpu.utils import rmse


def _toy_data(T=600, dt=1e-3, Xi=0.1, seed=555):
    ts = jnp.linspace(dt, dt * T, T)
    freq_func, phase_func = meow_freq(offset=8.0)
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    true_chirp = gen_chirp(ts, constant_mag(1.0), phase_func)
    ys = true_chirp + math.sqrt(Xi) * jax.random.normal(key, (T,))
    return ts, freq_func, ys


@pytest.mark.parametrize("method", ["ghfs", "ekfs"])
def test_mle_pipeline_recovers_if(method):
    ts, freq_func, ys = _toy_data()
    cfg = IFEstimationConfig(method=method, max_iters=100)
    opt, params, est = run_pipeline(cfg, ys)
    assert bool(opt.success)
    assert bool(jnp.all(jnp.isfinite(est["if_mean"])))
    err = rmse(freq_func(ts), est["if_mean"])
    # On this short window the IF is near-constant (~8 Hz); the posterior
    # mean must track it well after MLE.
    assert float(err) < 2.0, f"IF RMSE too high: {err}"


@pytest.mark.slow
def test_lbfgs_and_scipy_agree():
    """The in-JAX L-BFGS reaches an optimum at least as good as host SciPy
    L-BFGS-B on the filter NLL.  (SciPy may legitimately diverge on short
    windows -- the reference records such runs as NaN,
    ``tetralith/jobs/ghfs_mle.py:78-81`` -- so only compare when it
    succeeds.)"""
    _, _, ys = _toy_data(T=600)
    cfg_j = IFEstimationConfig(method="ghfs", optimizer="lbfgs")
    cfg_s = IFEstimationConfig(method="ghfs", optimizer="scipy")
    opt_j = fit_mle(cfg_j, ys)
    opt_s = fit_mle(cfg_s, ys)
    assert bool(opt_j.success)
    if bool(opt_s.success):
        assert float(opt_j.fun_val) <= float(opt_s.fun_val) + 1.0


def test_cd_methods_run():
    ts, freq_func, ys = _toy_data(T=200)
    for method in ["cd_ghfs", "cd_ekfs"]:
        cfg = IFEstimationConfig(method=method)
        params = g(cfg.default_init_theta())
        est = estimate_if(cfg, params, ys)
        assert bool(jnp.all(jnp.isfinite(est["if_mean"])))


def test_harmonic_pipeline_runs():
    T, dt, Xi = 300, 1e-3, 0.1
    ts = jnp.linspace(dt, dt * T, T)
    from chirpgp_tpu.toymodels import gen_harmonic_chirp, constant_mag, meow_freq
    _, phase = meow_freq(offset=8.0)
    ys = gen_harmonic_chirp(ts, [constant_mag(1.0), constant_mag(0.5)], phase)
    cfg = IFEstimationConfig(method="ghfs", model="harmonic",
                             num_harmonics=2, quadrature="cubature")
    params = g(cfg.default_init_theta())
    est = estimate_if(cfg, params, ys)
    assert est["mss"].shape == (T, 6)
    assert bool(jnp.all(jnp.isfinite(est["if_mean"])))


def test_estimate_if_batched_jits_and_matches_per_lane():
    """``estimate_if_batched`` compiles as one program (the model's
    measurement vector stays concrete under ``jit``) and equals the
    per-lane sqrt-form ``estimate_if``, with the scan unroll forwarded."""
    from chirpgp_tpu.apps import estimate_if_batched
    yss = jnp.stack([_toy_data(T=128, seed=s)[2] for s in (1, 2, 3)])
    params = g(IFEstimationConfig().default_init_theta())
    cfg = IFEstimationConfig(method="ghfs", form="sqrt", scan_unroll=4)
    out = jax.jit(lambda y: estimate_if_batched(cfg, params, y))(yss)
    assert out["if_mean"].shape == (3, 128)
    for i in range(3):
        ref = estimate_if(cfg, params, yss[i])
        npt.assert_allclose(out["if_mean"][i], ref["if_mean"],
                            rtol=1e-9, atol=1e-9)
