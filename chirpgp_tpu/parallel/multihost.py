"""Multi-host runtime utilities.

The reference's cross-node story is Slurm process fan-out with filesystem
joins (``tetralith/*.sh``).  Here a cluster is one JAX multi-controller
program: ``initialize_distributed`` brings up the runtime, and the global
mesh spans all hosts' devices, with XLA's collectives within and across
hosts.  All sweep/NUTS/SMC utilities in this package take
a mesh argument and are host-count agnostic.
"""

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize_distributed", "global_mesh", "process_info"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime (no-op on a single host).

    Where no cluster environment announces them, pass the coordinator
    address (``host:port``), process count and this process's id.
    """
    if num_processes is not None and num_processes <= 1:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(axis_name: str = "seeds") -> Mesh:
    """1-D mesh over ALL devices across hosts (``jax.devices()`` is global
    after ``initialize_distributed``)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def process_info():
    """(process_index, process_count, local_device_count)."""
    return (jax.process_index(), jax.process_count(),
            jax.local_device_count())
