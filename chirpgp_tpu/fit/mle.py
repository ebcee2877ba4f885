"""Hyperparameter MLE by gradient-through-the-filter.

Two optimizers over the filter-marginal negative log-likelihood:

- :func:`lbfgs_minimize`: an in-JAX L-BFGS (optax) driven by a
  ``lax.while_loop`` so the *entire* optimization -- filter scans,
  gradients, line searches -- is one XLA program on the device.  The reference
  instead round-trips host SciPy <-> jitted objective once per L-BFGS
  iteration (``demos/ghfs_mle.py:60-61`` via ``jaxopt.ScipyMinimize``).
- :func:`scipy_minimize`: host SciPy L-BFGS-B fallback with the exact
  reference semantics, including the ``success`` flag used to record
  divergent Monte-Carlo runs as NaN (``tetralith/jobs/ghfs_mle.py:78-81``).
"""

import os as _os
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax
import optax.tree_utils as otu

__all__ = ["lbfgs_minimize", "lbfgs_minimize_stepped", "scipy_minimize",
           "MLEResult"]


class MLEResult(NamedTuple):
    params: jnp.ndarray
    fun_val: jnp.ndarray
    num_iters: jnp.ndarray
    success: jnp.ndarray   # bool; False when the optimizer diverged


def lbfgs_minimize(fun: Callable, init_params, max_iters: int = 200,
                   tol: float = 1e-6, memory_size: int = 15,
                   jit: bool = True,
                   chunk_iters: Optional[int] = None) -> MLEResult:
    """Minimize ``fun`` (scalar, differentiable) fully inside XLA.

    Uses L-BFGS with zoom line search; the loop is a ``lax.while_loop`` with
    a gradient-norm stopping rule, so calling this inside a larger jitted
    program (e.g. a sharded Monte-Carlo sweep) is fine.

    ``chunk_iters`` splits the optimization into host-stepped dispatches of
    at most that many iterations each (same results; the while_loop bound
    moves), e.g. to observe progress from the host.
    """
    opt = optax.lbfgs(memory_size=memory_size)
    value_and_grad = optax.value_and_grad_from_state(fun)

    def step(carry):
        params, state = carry
        value, grad = value_and_grad(params, state=state)
        updates, state = opt.update(grad, state, params, value=value,
                                    grad=grad, value_fn=fun)
        params = optax.apply_updates(params, updates)
        return params, state

    def continuing_until(bound):
        def continuing(carry):
            _, state = carry
            count = otu.tree_get(state, "count")
            grad = otu.tree_get(state, "grad")
            err = otu.tree_norm(grad)
            return (count == 0) | ((count < bound) & (err >= tol))
        return continuing

    def finish(params, state):
        value = otu.tree_get(state, "value")
        count = otu.tree_get(state, "count")
        finite = jnp.isfinite(value) & jnp.all(jnp.isfinite(params))
        return MLEResult(params, value, count, finite)

    if chunk_iters is None:
        def run(params0):
            init = (params0, opt.init(params0))
            params, state = jax.lax.while_loop(
                continuing_until(max_iters), step, init)
            return finish(params, state)

        return jax.jit(run)(init_params) if jit else run(init_params)

    # Host-chunked: each dispatch advances at most chunk_iters iterations.
    # The bound is a traced argument so every chunk reuses one compile.
    def run_chunk(params, state, bound):
        return jax.lax.while_loop(continuing_until(bound), step,
                                  (params, state))

    run_chunk_j = jax.jit(run_chunk)
    params, state = init_params, opt.init(init_params)
    bound = 0
    while bound < max_iters:
        bound = min(bound + chunk_iters, max_iters)
        params, state = run_chunk_j(params, state, jnp.asarray(bound))
        count = int(otu.tree_get(state, "count"))
        err = float(otu.tree_norm(otu.tree_get(state, "grad")))
        if count < bound or err < tol:
            break
    return finish(params, state)


def _ckpt_fingerprint(tag: str, init_params, batch_args) -> str:
    """Checkpoint identity: the caller's tag (method/T/form/...) plus the
    shapes+dtypes of the init and every batch arg.  A checkpoint from a
    different objective or measurement set must never be resumed just
    because the (B, n_params) shape happens to match (round-3 advisor
    finding: a stale foreign checkpoint silently poisoned a sweep)."""
    import hashlib
    import json as _json
    spec = [str(tag),
            [list(map(int, init_params.shape)), str(init_params.dtype)],
            [[list(map(int, a.shape)), str(a.dtype)] for a in batch_args]]
    return hashlib.sha256(_json.dumps(spec).encode()).hexdigest()


def lbfgs_minimize_stepped(fun: Callable, init_params, batch_args=(),
                           max_iters: int = 200, tol: float = 1e-6,
                           memory_size: int = 15,
                           max_linesearch_steps: int = 15,
                           ftol_rel: float = 1e-6, patience: int = 3,
                           checkpoint_path: Optional[str] = None,
                           checkpoint_every: int = 5,
                           checkpoint_tag: str = "",
                           tail_frac: float = 0.01,
                           tail_iters: Optional[int] = None,
                           verbose: bool = False) -> MLEResult:
    """Batched L-BFGS advanced ONE iteration per device dispatch.

    ``fun(params, *args)`` is the per-seed scalar objective;
    ``init_params`` has a leading batch axis, as does every entry of
    ``batch_args``.  All seeds step in lockstep under ``vmap``; seeds
    whose gradient norm drops below ``tol`` (or goes non-finite) are
    frozen -- their updates are masked out (under lockstep vmap every
    dispatch still evaluates the objective and line search for frozen
    lanes; only the results are discarded).

    ``ftol_rel``/``patience`` control the host-side stall freeze: a seed
    whose NLL improves by less than ``ftol_rel * max(1, |f|)`` for
    ``patience`` consecutive iterations is frozen.  The default 1e-6 is
    looser than scipy L-BFGS-B's ftol (~2.2e-9); tighten it when parity
    with a monolithic/scipy run matters more than sweep wall-time.

    Rationale: a monolithic ``lax.while_loop`` L-BFGS over a T~3000
    filter is one minutes-long XLA dispatch, which the first backend this
    ran on could not survive (not re-established on the H100, ROADMAP
    D4).  Host-stepping one
    batched iteration per dispatch matches the short-dispatch cadence of
    the robust SciPy path while keeping every seed on-device -- the same
    optimizer math as :func:`lbfgs_minimize`, sliced differently in time.
    Results per seed are identical to a vmapped monolithic run up to the
    freezing of converged seeds and -- when the tail cap is enabled -- of
    tail-capped stragglers, which are frozen while NOT converged and
    return their best-so-far iterate.

    ``tail_frac``/``tail_iters`` bound the lockstep tail: once the
    active-lane count drops to ``max(1, tail_frac * B)`` lanes AND at
    least one lane has already been frozen (``n_active < B`` -- so a
    tiny batch that *starts* at the threshold is never capped from
    iteration one), at most ``tail_iters`` further iterations run
    before the stragglers are frozen at their best iterate.  Under
    lockstep vmap every iteration dispatches the FULL batch, so a
    single non-stalling lane otherwise burns ``max_iters`` full-batch
    dispatches for one seed (measured r4: ~150 x ~30 s on a cd_ekfs
    column for 1/300 lanes).  Frozen stragglers keep their best-so-far
    iterate and remain subject to the sweeps' divergence rescue and f64
    polish, which is where hard lanes are actually salvaged.
    ``tail_iters=None`` (the default) disables the cap; the Table-I
    sweep drivers opt in with ``tail_iters=30``.

    ``checkpoint_path`` enables crash recovery for long sweeps: every ``checkpoint_every``
    iterations the host-side sweep state (current + best iterates, stall
    counters, iteration index) is written atomically to that path, and a
    fresh call with the same path RESUMES from it instead of restarting.
    The optax L-BFGS curvature memory is deliberately NOT serialized --
    resumption warm-restarts L-BFGS from the saved iterate (same
    optimum, a few extra iterations to rebuild curvature).  Delete the
    file after harvesting the result.
    """
    opt = optax.lbfgs(
        memory_size=memory_size,
        linesearch=optax.scale_by_zoom_linesearch(
            max_linesearch_steps=max_linesearch_steps))

    def one_step(params, state, args, still_going):
        fun_i = lambda p: fun(p, *args)
        value_and_grad = optax.value_and_grad_from_state(fun_i)
        count = otu.tree_get(state, "count")
        grad0 = otu.tree_get(state, "grad")
        err = otu.tree_norm(grad0)
        active = still_going & ((count == 0) | (err >= tol))

        value, grad = value_and_grad(params, state=state)
        updates, new_state = opt.update(grad, state, params, value=value,
                                        grad=grad, value_fn=fun_i)
        new_params = optax.apply_updates(params, updates)
        sel = lambda a, b: jnp.where(active, a, b)
        params = jax.tree.map(sel, new_params, params)
        state = jax.tree.map(sel, new_state, state)
        return params, state, active

    import numpy as np

    # Best-iterate tracking below assumes a single (B, p) params array;
    # pytree/1-D inits would silently broadcast wrongly.
    assert (isinstance(init_params, (jnp.ndarray, np.ndarray))
            and init_params.ndim == 2), \
        "lbfgs_minimize_stepped requires a 2-D (batch, params) array"

    step_j = jax.jit(jax.vmap(one_step, in_axes=(0, 0, 0, 0)))
    B = init_params.shape[0]

    fingerprint = _ckpt_fingerprint(checkpoint_tag, init_params, batch_args)
    ckpt = None
    if checkpoint_path is not None and _os.path.exists(checkpoint_path):
        ckpt = np.load(checkpoint_path)
        if ckpt["params"].shape != tuple(init_params.shape):
            ckpt = None   # stale checkpoint from a different sweep shape
        elif ("fingerprint" not in ckpt
              or str(ckpt["fingerprint"]) != fingerprint):
            # A shape-compatible checkpoint from a DIFFERENT objective /
            # measurement set / config (or a pre-fingerprint file): never
            # resume it -- mixing optimizer state across problems reports
            # a foreign sweep's params as this sweep's results.
            print(f"  lbfgs: ignoring checkpoint {checkpoint_path} "
                  f"(fingerprint mismatch -- different sweep)", flush=True)
            ckpt = None

    if ckpt is not None:
        it0 = int(ckpt["it"])
        params = jnp.asarray(ckpt["params"])
        best = np.asarray(ckpt["best"], dtype=np.float64)
        best_params = np.asarray(ckpt["best_params"]).copy()
        best_count = np.asarray(ckpt["best_count"]).copy()
        stall = np.asarray(ckpt["stall"]).copy()
        still_going = jnp.asarray(ckpt["still_going"])
        params_np = np.asarray(ckpt["params"]).copy()
        # Resumption always announced (not only under verbose): silently
        # resuming is how foreign state sneaks into results.
        print(f"  lbfgs resume from {checkpoint_path} at iter {it0} "
              f"(active={int(np.sum(np.asarray(still_going)))})",
              flush=True)
    else:
        it0 = 0
        params = init_params
        # Host-side stall freeze: scipy L-BFGS-B's ftol rule adapted to
        # f32 -- a seed whose NLL improves by < ftol_rel * max(1, |f|)
        # for `patience` consecutive iterations has converged for all
        # practical purposes (f32 gradient norms rarely reach a fixed
        # small tol).  best starts at f(init) so the returned iterate can
        # never be worse than the init point (a failed first line search
        # can step uphill).
        f_init_j = jax.jit(jax.vmap(lambda p, *a: fun(p, *a)))
        best = np.asarray(
            jax.device_get(f_init_j(init_params, *batch_args)),
            dtype=np.float64)
        stall = np.zeros((B,), dtype=np.int64)
        still_going = jnp.ones((B,), dtype=bool)
        # Best-iterate tracking: a failed zoom line search can step
        # UPHILL (observed: lanes retired thousands of nats above their
        # own best point), so the returned iterate is the lowest-NLL one
        # each lane ever visited, not the last.  Params are a few floats
        # per lane -- the per-iteration host transfer is negligible next
        # to the filter dispatch itself.
        best_params = np.asarray(jax.device_get(init_params)).copy()
        best_count = np.zeros((B,), dtype=np.int64)
        params_np = best_params

    state = jax.vmap(opt.init)(params)

    def _save_ckpt(it_next):
        tmp = checkpoint_path + ".tmp.npz"   # np.savez appends .npz itself
        np.savez(tmp[:-4], it=it_next, params=params_np, best=best,
                 best_params=best_params, best_count=best_count,
                 stall=stall,
                 still_going=np.asarray(jax.device_get(still_going)),
                 fingerprint=np.asarray(fingerprint))
        _os.replace(tmp, checkpoint_path)

    tail_thresh = max(1, int(np.ceil(tail_frac * B)))
    tail_left = None
    for it in range(it0, max_iters):
        params, state, active = step_j(params, state, batch_args,
                                       still_going)
        vals = np.asarray(jax.device_get(otu.tree_get(state, "value")))
        with np.errstate(invalid="ignore"):   # NaN seeds never "improve"
            improved = vals < best - ftol_rel * np.maximum(1.0, np.abs(best))
            better = vals < best
        params_np = np.asarray(jax.device_get(params))
        best_params = np.where(better[:, None], params_np, best_params)
        best_count = np.where(better, it + 1, best_count)
        stall = np.where(improved, 0, stall + 1)
        # fmin (NaN-ignoring): a transient NaN iteration must not poison
        # the tracked best, which stays consistent with best_params.
        best = np.fmin(best, vals)
        active_np = np.asarray(jax.device_get(active))
        still_going = jnp.asarray(active_np & (stall < patience))
        n_active = int(np.sum(np.asarray(jax.device_get(still_going))))
        if checkpoint_path is not None and (it + 1) % checkpoint_every == 0:
            _save_ckpt(it + 1)
        if verbose:
            print(f"  lbfgs iter {it + 1}: active={n_active} "
                  f"median_nll={float(np.nanmedian(vals)):.3f}",
                  flush=True)
        if n_active == 0:
            break
        if (tail_iters is not None and 0 < n_active <= tail_thresh
                and n_active < B):
            tail_left = tail_iters if tail_left is None else tail_left - 1
            if tail_left <= 0:
                if verbose:
                    print(f"  lbfgs tail cap: freezing {n_active} "
                          f"straggler lane(s) at best iterate after "
                          f"{tail_iters} tail iterations", flush=True)
                break

    value = jnp.asarray(best.astype(params_np.dtype))
    params = jnp.asarray(best_params)
    count = jnp.asarray(best_count)
    finite = jnp.isfinite(value) & jnp.all(jnp.isfinite(params), axis=-1)
    return MLEResult(params, value, count, finite)


def scipy_minimize(fun: Callable, init_params, method: str = "L-BFGS-B",
                   **kwargs) -> MLEResult:
    """Host SciPy optimization of a jitted value-and-grad objective --
    the reference's optimizer contract (``jaxopt.ScipyMinimize`` with
    ``jit=True``)."""
    import numpy as np
    from scipy.optimize import minimize

    vg = jax.jit(jax.value_and_grad(fun))

    def fun_np(x):
        v, g = vg(jnp.asarray(x))
        return float(v), np.asarray(g, dtype=np.float64)

    res = minimize(fun_np, np.asarray(init_params, dtype=np.float64),
                   method=method, jac=True, **kwargs)
    return MLEResult(jnp.asarray(res.x), jnp.asarray(res.fun),
                     jnp.asarray(res.nit), jnp.asarray(bool(res.success)))
