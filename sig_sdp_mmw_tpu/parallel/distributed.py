"""Multi-host initialization + mesh construction.

The reference is single-process (SURVEY §2.6/§5.8: no MPI/NCCL/Gloo
anywhere).  The equivalent here is ``jax.distributed`` + XLA collectives
(NCCL on GPUs: NVLink within a host, the network across hosts).  This
module is the thin launcher layer: call :func:`init_distributed` once per
host process (coordinator address from the environment or args), then build
a global (batch, graph) mesh over all devices with
:func:`make_global_mesh`; everything else in the framework is
sharding-annotation driven and needs no further changes (validated on the
virtual multi-device mesh in tests/test_parallel.py).

Single-host multi-device needs no initialization at all — ``jax.devices()``
already enumerates the local devices.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
from jax.sharding import Mesh

from sig_sdp_mmw_tpu.parallel.mesh import make_mesh


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX.  No-ops when running single-process.

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) when present.
    """
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    n = num_processes or _env_int("JAX_NUM_PROCESSES")
    pid = process_id if process_id is not None else _env_int("JAX_PROCESS_ID")
    if addr is None and n in (None, 1):
        return  # single process
    jax.distributed.initialize(coordinator_address=addr, num_processes=n,
                               process_id=pid)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def make_global_mesh(batch_size: Optional[int] = None,
                     axis_names: Tuple[str, str] = ("batch", "graph")) -> Mesh:
    """(batch, graph) mesh over every device of every host."""
    return make_mesh(n_devices=len(jax.devices()), axis_names=axis_names,
                     batch_size=batch_size)
