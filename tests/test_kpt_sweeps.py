"""KPT baseline and Monte-Carlo sweep machinery tests."""

import math

import pytest
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt

from chirpgp_tpu.apps import (
    IFEstimationConfig, generate_rnd_keys, toymodel_measurements,
    mc_mle_sweep, print_rmse_table, kpt_filter, kpt_if_estimate,
    KPT_INIT_PARAMS)
from chirpgp_tpu.parallel import make_mesh
from chirpgp_tpu.toymodels import gen_chirp, constant_mag, affine_freq


def test_generate_rnd_keys_deterministic():
    k1 = generate_rnd_keys(10)
    k2 = generate_rnd_keys(10)
    npt.assert_array_equal(np.asarray(k1), np.asarray(k2))
    assert k1.shape[0] == 10


def test_toymodel_measurements_contract():
    keys = generate_rnd_keys(2)
    ts, freqs, ys = toymodel_measurements(keys[0], "const", T=100)
    assert ts.shape == (100,) and freqs.shape == (100,) and ys.shape == (100,)
    # Same key -> same data; different magnitude -> same noise stream.
    _, _, ys2 = toymodel_measurements(keys[0], "const", T=100)
    npt.assert_array_equal(np.asarray(ys), np.asarray(ys2))
    _, _, ys3 = toymodel_measurements(keys[1], "const", T=100)
    assert not np.allclose(np.asarray(ys), np.asarray(ys3))


def test_kpt_tracks_pure_tone():
    """KPT EKF+RTS tracks a constant-frequency tone."""
    dt, T = 1e-3, 2000
    fs = 1.0 / dt
    ts = jnp.linspace(dt, dt * T, T)
    f0 = 25.0
    _, phase = affine_freq(0.0, f0)
    key = jax.random.PRNGKey(0)
    Xi = 0.01
    ys = gen_chirp(ts, constant_mag(1.0), phase) \
        + math.sqrt(Xi) * jax.random.normal(key, (T,))
    params = jnp.array([0.5, 1e-4, 0.1, 24.0, 1.0])
    if_mean, nell = kpt_if_estimate(params, fs, Xi, ys)
    tail = np.asarray(if_mean[500:])
    npt.assert_allclose(tail.mean(), f0, rtol=0.05)


def test_mc_mle_sweep_small():
    """A small sharded MC sweep completes with finite RMSEs and the table
    printer formats it."""
    mesh = make_mesh()
    keys = generate_rnd_keys(8)
    cfg = IFEstimationConfig(method="ekfs", max_iters=40)
    res = mc_mle_sweep(cfg, keys, "const", T=300, mesh=mesh)
    assert res["rmse"].shape == (8,)
    assert res["params"].shape == (8, 6)
    # At least some seeds converge on this easy config.
    assert np.sum(np.isfinite(res["rmse"])) >= 4
    table = print_rmse_table({"ekfs": {"const": res}})
    assert "ekfs" in table


@pytest.mark.slow
def test_sweep_shard_invariance():
    """Sharded sweep equals unsharded vmap sweep."""
    keys = generate_rnd_keys(8)
    cfg = IFEstimationConfig(method="ekfs", max_iters=25)
    res_mesh = mc_mle_sweep(cfg, keys, "const", T=200, mesh=make_mesh())
    res_vmap = mc_mle_sweep(cfg, keys, "const", T=200, mesh=None)
    npt.assert_allclose(res_mesh["rmse"], res_vmap["rmse"],
                        rtol=1e-6, atol=1e-8)


@pytest.mark.slow
def test_stepped_sweep_matches_monolithic():
    """Host-stepped batched L-BFGS sweep (one dispatch per iteration)
    agrees with the monolithic vmapped while_loop sweep."""
    from chirpgp_tpu.apps.sweeps import mc_mle_sweep_stepped

    keys = generate_rnd_keys(4)
    cfg = IFEstimationConfig(method="ekfs", max_iters=30)
    res_step = mc_mle_sweep_stepped(cfg, keys, "const", T=250)
    res_mono = mc_mle_sweep(cfg, keys, "const", T=250, mesh=None)
    assert res_step["rmse"].shape == (4,)
    assert np.all(res_step["success"])
    # Same optimum up to line-search path differences / stall freezing.
    npt.assert_allclose(res_step["rmse"], res_mono["rmse"],
                        rtol=0.05, atol=5e-3)


@pytest.mark.slow
def test_stepped_sweep_mixed_measurements():
    """mle_sweep_on_measurements runs mixed-scenario batches (the
    all-magnitudes-in-one-program mode) and keeps per-seed pairing."""
    from chirpgp_tpu.apps.sweeps import (
        mle_sweep_on_measurements, toymodel_measurements)
    import functools

    keys = generate_rnd_keys(2)
    cfg = IFEstimationConfig(method="ekfs", max_iters=25)
    tfs, yss = [], []
    for mag in ("const", "damped"):
        gen = functools.partial(toymodel_measurements, mag_name=mag,
                                dt=cfg.dt, T=250, Xi=cfg.Xi)
        _, tf, ys = jax.jit(jax.vmap(gen))(keys)
        tfs.append(tf)
        yss.append(ys)
    res = mle_sweep_on_measurements(cfg, jnp.concatenate(tfs),
                                    jnp.concatenate(yss))
    assert res["rmse"].shape == (4,)
    # Per-magnitude halves must equal the single-magnitude stepped runs.
    from chirpgp_tpu.apps.sweeps import mc_mle_sweep_stepped
    res_const = mc_mle_sweep_stepped(cfg, keys, "const", T=250)
    npt.assert_allclose(res["rmse"][:2], res_const["rmse"],
                        rtol=1e-5, atol=1e-6)


def test_f64_polish_never_worse_and_reaches_f64_optimum():
    """_polish_lanes_f64 is a warm-started f64 L-BFGS-B refinement: it
    must never return a lane above its f32 NLL, and from a deliberately
    detuned iterate it must recover the optimizer's own optimum."""
    from chirpgp_tpu.apps.pipeline import make_nll_fn
    from chirpgp_tpu.apps.sweeps import (_polish_lanes_f64,
                                         toymodel_measurements)
    from chirpgp_tpu.fit.mle import MLEResult

    keys = generate_rnd_keys(1)
    cfg = IFEstimationConfig(method="ekfs", max_iters=60)
    import functools
    gen = functools.partial(toymodel_measurements, mag_name="const",
                            dt=cfg.dt, T=250, Xi=cfg.Xi)
    _, _, ys1 = jax.jit(jax.vmap(gen))(keys)
    yss = jnp.concatenate([ys1, ys1])   # SAME record in both lanes

    def nll(theta, ys_i):
        return make_nll_fn(cfg, ys_i)(theta)

    init = cfg.default_init_theta()
    # detuned starts: lane 0 at the init, lane 1 slightly perturbed
    theta0 = jnp.stack([init, init + 0.05])
    v0 = jax.vmap(nll)(theta0, yss)
    fake = MLEResult(theta0, v0, jnp.zeros(2, jnp.int64),
                     jnp.ones(2, dtype=bool))
    out = _polish_lanes_f64(nll, init, fake, yss, max_iters=100)
    v_polished = np.asarray(out.fun_val)
    assert np.all(v_polished <= np.asarray(v0) + 1e-3)
    # both lanes see the same record from nearby starts: same optimum
    npt.assert_allclose(np.asarray(out.fun_val[0]),
                        np.asarray(out.fun_val[1]), rtol=0.02)


def test_stepped_checkpoint_resume(tmp_path):
    """Crash-recovery checkpointing: an interrupted stepped sweep
    resumes from its checkpoint and lands on the same optima as an
    uninterrupted run (fresh L-BFGS memory after resume is allowed a
    small tolerance)."""
    from chirpgp_tpu.fit.mle import lbfgs_minimize_stepped

    def quartic(p, a):
        return jnp.sum((p - a) ** 2) + 0.1 * jnp.sum(p ** 4)

    B = 4
    init = jnp.zeros((B, 3))
    targets = jnp.arange(B * 3, dtype=init.dtype).reshape(B, 3) / 10.0
    ck = str(tmp_path / "ck.npz")

    full = lbfgs_minimize_stepped(quartic, init, (targets,),
                                  max_iters=50, ftol_rel=1e-10)
    # "Interrupted" run: stops after 4 iterations, checkpointing every 2.
    lbfgs_minimize_stepped(quartic, init, (targets,), max_iters=4,
                           checkpoint_path=ck, checkpoint_every=2)
    import os
    assert os.path.exists(ck)
    resumed = lbfgs_minimize_stepped(quartic, init, (targets,),
                                     max_iters=50, ftol_rel=1e-10,
                                     checkpoint_path=ck,
                                     checkpoint_every=2)
    npt.assert_allclose(np.asarray(resumed.fun_val),
                        np.asarray(full.fun_val), rtol=1e-3, atol=1e-5)
    # A checkpoint from a different sweep shape must be ignored.
    other = lbfgs_minimize_stepped(quartic, jnp.zeros((2, 3)),
                                   (targets[:2],), max_iters=3,
                                   checkpoint_path=ck)
    assert other.params.shape == (2, 3)
