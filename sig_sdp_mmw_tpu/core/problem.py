"""The SIG-SDP problem ``state`` container — the framework's central ABI.

The reference threads a ``state = (S_gain csr, Q_asso csr, h_max ndarray)``
tuple through every layer (``sim_src/env/env.py:168-196`` produces it;
``sim_src/alg/mmw.py:26-41`` and ``sim_src/alg/sdp_solver.py:27-41`` consume
it).  Here, mutable scipy CSR is replaced by a static-shape, padded,
mask-aware dense container registered as a JAX pytree:

* ``S``      [Kp, Kp] float — interference gain matrix.  ``S[k, j]`` is the
  received-power ratio of user ``k`` at the AP associated with user ``j``
  (reference: ``S_gain = rxpr[:, asso]``, ``env.py:191``).  Diagonal is the
  user's own-AP gain.
* ``Q``      [Kp, Kp] float 0/1 — association cliques: ``Q[i, j] = 1`` iff
  users i≠j share an AP (``env.py:182-190``); zero diagonal.
* ``h_max``  [Kp] float — per-user interference budget
  ``diag(S)/min_sinr - 1`` (``env.py:195``).
* ``mask``   [Kp] bool — valid-user mask; padded rows/cols are all-zero.

``K`` (the number of real users) is static pytree metadata, so one compiled
solver serves every instance of a padded-size bucket.  Sparse problems at the
million-link scale use the ELL container in :mod:`sig_sdp_mmw_tpu.core.ell`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SigState:
    S: jax.Array       # [Kp, Kp]
    Q: jax.Array       # [Kp, Kp]
    h_max: jax.Array   # [Kp]
    mask: jax.Array    # [Kp] bool
    K: int = dataclasses.field(metadata=dict(static=True))

    @property
    def Kp(self) -> int:
        return self.S.shape[-1]

    def degree_bounds(self) -> Tuple[int, int]:
        """(lb, ub) for the binary search over Z, from graph degrees.

        Reference ``binary_search_relaxation.set_bounds``
        (``sim_src/alg/binary_search_relaxation.py:13-29``):
        lb = max association degree + 1; ub = max degree of S+S^T (off-diag
        nonzeros) + 1.  Host-side (bounds drive Python control flow).
        """
        Q = np.asarray(self.Q)
        S = np.asarray(self.S)
        mask = np.asarray(self.mask)
        lb = int((Q != 0).sum(axis=1).max()) + 1
        Ssym = (S != 0) | (S.T != 0)
        np.fill_diagonal(Ssym, False)
        Ssym = Ssym & mask[None, :] & mask[:, None]
        # +2, not +1: the reference's csr ``setdiag(0)`` keeps an explicit
        # stored zero on the diagonal, so its per-row nnz includes it
        # (binary_search_relaxation.py:21-26).  Replicated for parity.
        ub = int(Ssym.sum(axis=1).max()) + 2
        return lb, ub

    def asso_lower_bound(self) -> int:
        """lb = max association degree + 1 (``binary_search_relaxation.py:14-17``)."""
        Q = np.asarray(self.Q)
        return int((Q != 0).sum(axis=1).max()) + 1


def state_from_arrays(S, Q, h_max, pad_to: Optional[int] = None,
                      dtype=jnp.float32) -> SigState:
    """Build a :class:`SigState` from dense [K,K] arrays, padding to ``pad_to``
    (default: next multiple of 8)."""
    S = np.asarray(S)
    K = S.shape[0]
    Kp = pad_to if pad_to is not None else _round_up(K, 8)
    if Kp < K:
        raise ValueError(f"pad_to={Kp} < K={K}")

    def pad2(a):
        out = np.zeros((Kp, Kp), dtype=np.float64)
        out[:K, :K] = np.asarray(a)
        return jnp.asarray(out, dtype=dtype)

    hm = np.zeros((Kp,), dtype=np.float64)
    hm[:K] = np.asarray(h_max)
    mask = np.zeros((Kp,), dtype=bool)
    mask[:K] = True
    return SigState(S=pad2(S), Q=pad2(Q), h_max=jnp.asarray(hm, dtype=dtype),
                    mask=jnp.asarray(mask), K=K)


def state_from_scipy(state_tuple, pad_to: Optional[int] = None,
                     dtype=jnp.float32) -> SigState:
    """Interop: consume the reference's ``(S_csr, Q_csr, h_max)`` tuple."""
    S_csr, Q_csr, h_max = state_tuple
    return state_from_arrays(S_csr.toarray(), Q_csr.toarray(), h_max,
                             pad_to=pad_to, dtype=dtype)


def state_to_scipy(state: SigState):
    """Interop: produce the reference's ``(S_csr, Q_csr, h_max)`` tuple."""
    import scipy.sparse

    K = state.K
    S = np.asarray(state.S, dtype=np.float64)[:K, :K]
    Q = np.asarray(state.Q, dtype=np.float64)[:K, :K]
    h = np.asarray(state.h_max, dtype=np.float64)[:K]
    return (scipy.sparse.csr_matrix(S), scipy.sparse.csr_matrix(Q), h)
