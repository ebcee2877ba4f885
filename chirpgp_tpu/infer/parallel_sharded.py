"""Time-axis-sharded parallel Kalman filtering/smoothing: the SSM analog
of context parallelism.

For records too long for one chip (or to cut wall clock further), the
time axis itself is sharded over the mesh: each device runs a *local*
associative scan over its chunk of filtering elements, the per-shard
totals are exchanged with one ``all_gather`` (n_devices tiny elements),
an exclusive scan over shard totals yields each shard's prefix, and one
local combine applies it.  Associativity of the filtering/smoothing
elements makes the decomposition exact -- results match the single-device
scan to float tolerance.

Communication: a single all-gather of (n_shards, d, d)-sized element
tuples per pass over the device interconnect, independent of T.
"""

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from chirpgp_tpu.infer.parallel_kf import (
    _FilterElement, _combine_filter, _SmootherElement, _combine_smoother,
    _filter_elements, blocked_scan, filter_identity, smoother_identity)
from chirpgp_tpu.infer.common import log_normal_pdf
from chirpgp_tpu.utils.numerics import psd_solve_batched

__all__ = ["kf_parallel_time_sharded", "rts_parallel_time_sharded"]


def _tree_take(tree, idx):
    return jax.tree_util.tree_map(lambda x: x[idx], tree)


def _combine_batched(combine, a, b):
    """Combine two single elements (no leading axis) using the batched
    combinator."""
    a1 = jax.tree_util.tree_map(lambda x: x[None], a)
    b1 = jax.tree_util.tree_map(lambda x: x[None], b)
    out = combine(a1, b1)
    return jax.tree_util.tree_map(lambda x: x[0], out)


def _sharded_assoc_scan(combine, elems, axis: str, reverse: bool = False,
                        identity=None, block_size=None):
    """Associative scan over the leading (time) axis of ``elems``, where
    that axis is sharded over mesh axis ``axis``.  Call INSIDE shard_map:
    ``elems`` here is the local chunk.

    Exact algorithm: local inclusive scan; all-gather each shard's total
    (first element for reverse scans); exclusive prefix over shard totals
    (computed redundantly on every device -- n_shards elements); combine
    into the local chunk.

    ``block_size`` (with ``identity``) switches the LOCAL scan to the
    blocked form (``parallel_kf.blocked_scan``) -- the same
    local-scan + prefix-exchange decomposition applied one level down,
    with blocks inside the shard in place of shards inside the mesh.
    """
    if block_size is not None:
        local = blocked_scan(combine, elems, identity, block_size,
                             reverse=reverse)
    else:
        local = jax.lax.associative_scan(combine, elems, reverse=reverse)
    total_idx = 0 if reverse else -1
    my_total = _tree_take(local, total_idx)
    # (n_shards, ...) on every device.
    totals = jax.tree_util.tree_map(
        lambda x: jax.lax.all_gather(x, axis), my_total)
    n_shards = jax.lax.psum(1, axis)
    my_shard = jax.lax.axis_index(axis)

    def prefix_for(shard_idx):
        """Aggregate the totals of all shards strictly before this one
        (strictly after, for reverse scans), folded in scan order.

        Both directions use combine(acc, elem): for forward scans ``acc``
        is the earlier aggregate (first operand by the forward
        convention); for reverse scans ``acc`` is the later/suffix
        aggregate, which is also the first operand by the reverse
        convention (see ``_combine_smoother``).
        """
        def body(i, carry):
            has_prefix, acc = carry
            pos = i if not reverse else n_shards - 1 - i
            take = (pos < shard_idx) if not reverse else (pos > shard_idx)
            elem_i = _tree_take(totals, pos)
            combined = jax.lax.cond(
                has_prefix,
                lambda: _combine_batched(combine, acc, elem_i),
                lambda: elem_i)
            acc = jax.tree_util.tree_map(
                lambda old, new: jnp.where(take, new, old), acc, combined)
            has_prefix = has_prefix | take
            return has_prefix, acc

        init_acc = _tree_take(totals, 0)
        has_prefix, acc = jax.lax.fori_loop(
            0, n_shards, body, (jnp.zeros((), bool), init_acc))
        return has_prefix, acc

    has_prefix, prefix = prefix_for(my_shard)

    n_local = jax.tree_util.tree_leaves(local)[0].shape[0]
    prefix_b = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_local,) + x.shape), prefix)
    # The shard prefix/suffix occupies the first-operand slot in both
    # directions (earlier aggregate forward; later aggregate reversed).
    combined = combine(prefix_b, local)
    return jax.tree_util.tree_map(
        lambda with_p, without_p: jnp.where(has_prefix, with_p, without_p),
        combined, local)


def kf_parallel_time_sharded(F, Sigma, H, Xi, m0, P0, ys, mesh,
                             axis: str = "time",
                             block_size=None) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Parallel-in-time KF with the TIME axis sharded over ``mesh``.

    ``ys`` (T,) with T divisible by the mesh size.  Same contract as
    :func:`chirpgp_tpu.infer.parallel_kf.kf_parallel`; results match the
    unsharded scan.  ``block_size`` selects the blocked form for each
    shard's local scan (the single-chip fast path, measured in
    ``bench.py``).
    """
    if axis not in mesh.axis_names:
        axis = mesh.axis_names[0]
    elems = _filter_elements(F, Sigma, H, Xi, m0, P0, ys)
    ident = filter_identity(m0.shape[0], m0.dtype)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(_FilterElement(P(axis), P(axis), P(axis), P(axis),
                                      P(axis)),),
             out_specs=_FilterElement(P(axis), P(axis), P(axis), P(axis),
                                      P(axis)),
             check_vma=False)
    def scan_shards(local_elems):
        return _sharded_assoc_scan(_combine_filter, local_elems, axis,
                                   identity=ident, block_size=block_size)

    scanned = jax.jit(scan_shards)(elems)
    mfs, Pfs = scanned.b, scanned.C

    prev_m = jnp.concatenate([m0[None], mfs[:-1]], axis=0)
    prev_P = jnp.concatenate([P0[None], Pfs[:-1]], axis=0)
    mp = jnp.einsum("ij,tj->ti", F, prev_m)
    Pp = jnp.einsum("ij,tjk,lk->til", F, prev_P, F) + Sigma
    S = jnp.einsum("i,tij,j->t", H, Pp, H) + Xi
    nll = -log_normal_pdf(ys, mp @ H, S)
    return mfs, Pfs, jnp.cumsum(nll)


def rts_parallel_time_sharded(F, Sigma, mfs, Pfs, mesh,
                              axis: str = "time",
                              block_size=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Time-sharded parallel RTS smoother; matches
    :func:`chirpgp_tpu.infer.parallel_kf.rts_parallel`.

    The T-1 smoothing elements are padded with an identity element so the
    sharded axis length stays divisible by the mesh size.
    """
    if axis not in mesh.axis_names:
        axis = mesh.axis_names[0]
    T, d = mfs.shape
    Pf = Pfs[:-1]
    mf = mfs[:-1]
    Pp = jnp.einsum("ij,tjk,lk->til", F, Pf, F) + Sigma
    ET = psd_solve_batched(Pp, jnp.einsum("ij,tjk->tik", F, Pf))
    E = jnp.swapaxes(ET, -1, -2)
    g = mf - jnp.einsum("tij,jk,tk->ti", E, F, mf)
    L = Pf - E @ Pp @ jnp.swapaxes(E, -1, -2)

    # Identity element (E=I, g=0, L=0) pad at the END so the reverse scan
    # composes it harmlessly before every real element.
    E = jnp.concatenate([E, jnp.eye(d, dtype=E.dtype)[None]], axis=0)
    g = jnp.concatenate([g, jnp.zeros((1, d), g.dtype)], axis=0)
    L = jnp.concatenate([L, jnp.zeros((1, d, d), L.dtype)], axis=0)
    elems = _SmootherElement(E, g, L)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(_SmootherElement(P(axis), P(axis), P(axis)),),
             out_specs=_SmootherElement(P(axis), P(axis), P(axis)),
             check_vma=False)
    def scan_shards(local_elems):
        return _sharded_assoc_scan(_combine_smoother, local_elems, axis,
                                   reverse=True,
                                   identity=smoother_identity(d, mfs.dtype),
                                   block_size=block_size)

    scanned = jax.jit(scan_shards)(elems)
    E_s, g_s, L_s = scanned.E[:-1], scanned.g[:-1], scanned.L[:-1]
    mss = jnp.einsum("tij,j->ti", E_s, mfs[-1]) + g_s
    Pss = E_s @ Pfs[-1] @ jnp.swapaxes(E_s, -1, -2) + L_s
    return jnp.concatenate([mss, mfs[-1][None]]), \
        jnp.concatenate([Pss, Pfs[-1][None]])
