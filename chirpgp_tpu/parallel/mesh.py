"""Device-mesh scale-out for Monte-Carlo sweeps.

The reference parallelizes MC seeds with single-process ``jax.vmap`` plus
bash/Slurm process fan-out (``tetralith/run_local.sh``, SURVEY.md 2.4).
Here the seed axis is a first-class mesh axis: sweeps are ``shard_map``-ped
over devices with per-shard ``vmap``, and reductions ride XLA collectives
(``psum``) over the device interconnect.  Multi-host runs extend the
same mesh via
``jax.distributed.initialize`` -- the program does not change.
"""

from functools import partial
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_keys", "sharded_seed_sweep", "sharded_mean",
           "pad_to_multiple"]


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "seeds") -> Mesh:
    """1-D mesh over the first ``n_devices`` local devices (all by
    default)."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return Mesh(np.asarray(devs[:n]), (axis_name,))


def pad_to_multiple(x: jnp.ndarray, m: int, axis: int = 0):
    """Pad ``x`` along ``axis`` to a multiple of ``m``; returns the padded
    array and the original length."""
    n = x.shape[axis]
    rem = (-n) % m
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return jnp.pad(x, pad, mode="edge"), n


def shard_keys(keys: jnp.ndarray, mesh: Mesh):
    """Place a leading seed axis of PRNG keys on the mesh."""
    axis = mesh.axis_names[0]
    return jax.device_put(keys, NamedSharding(mesh, P(axis)))


def sharded_seed_sweep(per_seed_fn: Callable, keys: jnp.ndarray,
                       mesh: Optional[Mesh] = None) -> jnp.ndarray:
    """Run ``per_seed_fn(key) -> pytree`` for every key, sharded over the
    mesh with a per-shard ``vmap``.

    ``keys`` must have a leading axis divisible by the mesh size (use
    :func:`pad_to_multiple`).  Results come back sharded along the same
    axis; index/`jax.device_get` as needed.
    """
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]

    # check_vma off: replicated scan carries become device-varying through
    # sharded inputs, which the strict varying-axes checker rejects.
    @partial(jax.shard_map, mesh=mesh, in_specs=P(axis), out_specs=P(axis),
             check_vma=False)
    def sweep(local_keys):
        return jax.vmap(per_seed_fn)(local_keys)

    return jax.jit(sweep)(keys)


def sharded_mean(per_seed_fn: Callable, keys: jnp.ndarray,
                 mesh: Optional[Mesh] = None):
    """Mean of ``per_seed_fn(key)`` over all seeds, reduced with ``psum``
    inside the mesh (the CRLB / MC-error reduction pattern,
    SURVEY.md 3.4)."""
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    n_total = keys.shape[0]

    @partial(jax.shard_map, mesh=mesh, in_specs=P(axis), out_specs=P(),
             check_vma=False)
    def sweep(local_keys):
        local = jax.vmap(per_seed_fn)(local_keys)
        local_sum = jax.tree_util.tree_map(
            lambda x: jnp.sum(x, axis=0), local)
        return jax.tree_util.tree_map(
            lambda x: jax.lax.psum(x, axis) / n_total, local_sum)

    return jax.jit(sweep)(keys)
