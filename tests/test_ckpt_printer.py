"""Checkpoint-fingerprint and paired-printer regression tests.

Pins two review fixes:

- a shape-compatible checkpoint from a DIFFERENT sweep (other tag,
  other measurement set, or a pre-fingerprint file) must never be
  resumed (a stale foreign ``.ckpt_harmonic_ekfs.npz`` once silently
  poisoned a fresh sweep);
- ``experiments/print_table.py --paired`` must reproduce the
  seed-paired both-finite statistics PARITY.md quotes, from the
  ``.npz`` files alone, with the reference
  printer's NaN accounting
  (``paper_plots_tables/print_rmse_table.py:47-56``) extended to
  both sides.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from chirpgp_tpu.fit.mle import lbfgs_minimize_stepped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quad(p, target):
    d = p - target
    return jnp.sum(d * d)


@pytest.fixture
def quad_problem():
    targets = jnp.asarray(np.linspace(-1.0, 2.0, 6).reshape(3, 2))
    init = jnp.zeros((3, 2))
    return init, (targets,)


def _run(init, batch_args, ckpt, tag, max_iters=4):
    return lbfgs_minimize_stepped(
        _quad, init, batch_args, max_iters=max_iters,
        checkpoint_path=ckpt, checkpoint_every=2, checkpoint_tag=tag)


def test_ckpt_resume_same_sweep(tmp_path, quad_problem, capsys):
    init, batch_args = quad_problem
    ckpt = str(tmp_path / "ckpt.npz")
    _run(init, batch_args, ckpt, tag="sweepA", max_iters=4)
    assert os.path.exists(ckpt)
    capsys.readouterr()
    res = _run(init, batch_args, ckpt, tag="sweepA", max_iters=8)
    out = capsys.readouterr().out
    # Resumption is announced unconditionally (not only under verbose).
    assert "resume" in out and "fingerprint mismatch" not in out
    assert np.allclose(np.asarray(res.params), np.asarray(batch_args[0]),
                       atol=1e-5)


def test_ckpt_foreign_tag_ignored(tmp_path, quad_problem, capsys):
    init, batch_args = quad_problem
    ckpt = str(tmp_path / "ckpt.npz")
    _run(init, batch_args, ckpt, tag="harmonic_ekfs|T=3141")
    capsys.readouterr()
    _run(init, batch_args, ckpt, tag="cd_ekfs|T=3141")
    out = capsys.readouterr().out
    assert "fingerprint mismatch" in out and "resume from" not in out


def test_ckpt_foreign_data_ignored(tmp_path, quad_problem, capsys):
    # Same tag and same (B, p) shape, but different measurement-set
    # shapes in batch_args: the r3 failure mode (shape-only check).
    init, (targets,) = quad_problem
    ckpt = str(tmp_path / "ckpt.npz")
    _run(init, (targets,), ckpt, tag="sweepA")
    capsys.readouterr()
    _run(init, (targets.astype(jnp.float32),), ckpt, tag="sweepA")
    out = capsys.readouterr().out
    assert "fingerprint mismatch" in out


def test_ckpt_prefingerprint_file_ignored(tmp_path, quad_problem, capsys):
    init, batch_args = quad_problem
    ckpt = str(tmp_path / "ckpt.npz")
    _run(init, batch_args, ckpt, tag="sweepA")
    d = dict(np.load(ckpt))
    d.pop("fingerprint")
    np.savez(ckpt[:-4], **d)
    capsys.readouterr()
    _run(init, batch_args, ckpt, tag="sweepA")
    out = capsys.readouterr().out
    assert "fingerprint mismatch" in out


def test_tail_cap_freezes_stragglers(capsys):
    """One never-stalling lane must not burn max_iters full-batch
    dispatches: the tail cap freezes it at its best iterate (r4: a
    1/300 straggler cost ~150 extra batched iterations on a Table-I
    column)."""
    def fun(p, kind):
        quad = jnp.sum((p - 1.0) ** 2)
        slide = -0.01 * p[0]          # unbounded: improves every iter
        return jnp.where(kind > 0.5, quad, slide)

    kinds = jnp.array([1.0, 1.0, 1.0, 0.0])
    init = jnp.zeros((4, 2))
    res = lbfgs_minimize_stepped(fun, init, (kinds,), max_iters=500,
                                 tail_frac=0.25, tail_iters=5,
                                 verbose=True)
    out = capsys.readouterr().out
    assert "tail cap" in out
    # Converged lanes unaffected by the cap.
    assert np.allclose(np.asarray(res.params[:3]), 1.0, atol=1e-4)


def test_tail_cap_not_engaged_from_start(capsys):
    """A batch whose active count STARTS at the tail
    threshold (e.g. B=1, where tail_thresh=1) must run to max_iters /
    convergence, not be silently truncated to ~tail_iters iterations --
    the cap requires at least one lane to have been frozen first."""
    def fun(p, _):
        return -0.01 * p[0]           # unbounded: never stalls

    init = jnp.zeros((1, 2))
    lbfgs_minimize_stepped(fun, init, (jnp.zeros((1,)),), max_iters=25,
                           tail_frac=0.25, tail_iters=3, verbose=True)
    out = capsys.readouterr().out
    assert "tail cap" not in out
    assert "iter 25" in out           # ran the full budget


def test_paired_printer_stats(tmp_path):
    """--paired restricts to both-finite seeds and reports med ratio
    and per-side NaN counts."""
    ours_dir = tmp_path / "results"
    ref_dir = tmp_path / "results" / "reference"
    ref_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    ref = rng.uniform(0.2, 1.0, size=100)
    ours = ref * 1.5                      # exact per-seed ratio 1.5
    ours[:7] = np.nan                     # ours-only NaN
    ref[7:10] = np.nan                    # ref-only NaN
    np.savez(ours_dir / "ckfs_const.npz", rmse=ours / 10.0)
    np.savez(ref_dir / "ckfs_const.npz", rmse=ref / 10.0)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "experiments", "print_table.py"),
         "--paired", "--results", str(ours_dir),
         "--reference", str(ref_dir)],
        capture_output=True, text=True, check=True, cwd=REPO).stdout
    row = next(l for l in out.splitlines() if l.startswith("ckfs"))
    cols = row.split()
    assert cols[2] == "90"                # both-finite pairs
    assert cols[5] == "1.500"             # per-seed median ratio
    assert cols[7] == "7/3"               # NaN ours/ref
