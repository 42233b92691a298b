"""Device mesh construction for scenario-batch x graph-shard parallelism.

The reference is single-process numpy (SURVEY §2.6: no parallelism of any
kind); its scale axes are (a) outer for-loops over independent scenarios and
(b) CSR sparsity.  The equivalents here (SURVEY §5.7-5.8):

* ``batch`` mesh axis — independent scenario instances (the seed loops of
  ``sim_script/journal_version/sim_all_bler.py:30-31``) sharded across devices;
* ``graph`` mesh axis — the user/link axis K of the state matrices
  row-partitioned across devices; XLA GSPMD inserts the psum/all-gather
  collectives for the Lanczos matvecs and constraint reductions.

The mesh is a logical grid over ``jax.devices()``; nothing assumes a
physical topology (every GPU of a host reaches every other over NVLink).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("batch", "graph"),
              batch_size: Optional[int] = None) -> Mesh:
    """Build a 2D (batch, graph) mesh over the first ``n_devices`` devices.

    ``batch_size`` fixes the batch-axis length; by default the mesh is
    factored as evenly as possible with batch >= graph.
    """
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if batch_size is None:
        batch_size = 1
        for b in range(int(np.sqrt(n)), 0, -1):
            if n % b == 0:
                batch_size = b
                break
    if n % batch_size:
        raise ValueError(f"batch_size {batch_size} does not divide {n}")
    arr = np.asarray(devs[:n]).reshape(batch_size, n // batch_size)
    return Mesh(arr, axis_names)
