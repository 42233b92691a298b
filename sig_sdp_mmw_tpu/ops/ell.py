"""ELL sparse matrix-times-block kernels — the hot op of the sparse backend.

Replaces scipy's CSR SpMV/SpMM (the compiled kernel behind ``mmw.py:91,133``
and inside ``expm_multiply``):

* :func:`ell_spmm` — pure-XLA gather + weighted segment reduction.  XLA
  lowers the row gather to a dynamic-gather loop; fine at moderate sizes and
  fully differentiable/shardable.
* The block-sparse alternative is :func:`sig_sdp_mmw_tpu.ops.bcsr.bcsr_spmm`
  (one batched ``dot_general`` over dense blocks), which the large-K solver
  uses.  Which of the two moves fewer bytes per useful FLOP on a given
  device, at a given block fill, is measured, not assumed.

``out[k, :] = sum_d vals[k, d] * V[cols[k, d], :]``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def ell_spmm(cols: jax.Array, vals: jax.Array, V: jax.Array) -> jax.Array:
    """[Kp, deg] ELL x [Kp, D] block -> [Kp, D]; XLA path.

    Accumulates slot-by-slot: each step is one [Kp]-row gather of V plus a
    scaled add — peak live memory O(Kp * D), never the [Kp, deg, D] blowup a
    fused gather-einsum would materialize.
    """
    deg = cols.shape[1]

    def slot(d, acc):
        return acc + vals[:, d][:, None] * V[cols[:, d]]

    return lax.fori_loop(0, deg, slot, jnp.zeros_like(V))


def ell_edge_gather_dot(a_i: jax.Array, a_j: jax.Array, X_half: jax.Array
                        ) -> jax.Array:
    """Per-edge inner products ``<X_half[i], X_half[j]>`` for an edge list —
    the sparse-pattern Gram entries (``mmw.py:187-190``) without ever
    materializing X."""
    return jnp.sum(X_half[a_i] * X_half[a_j], axis=1)
