"""Randomized low-rank factorization (subspace iteration).

Compiled replacement for ARPACK ``svds`` in the reference's final
factorization ``svds(X_avgd, k) -> X_half = U sqrt(s)``
(``sim_src/alg/mmw.py:213-216``).  Jittable, fixed iteration count, all
matmul/QR.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def randomized_symmetric_lowrank(A: jax.Array, rank: int, key: jax.Array,
                                 oversample: int = 8, iters: int = 3
                                 ) -> Tuple[jax.Array, jax.Array]:
    """Top-``rank`` singular pairs of a symmetric matrix A.

    Returns (U [K, rank], s [rank]) with ``A ~= U diag(s_signed) U^T``;
    ``s`` are singular values (absolute eigenvalues), matching ARPACK
    ``svds`` semantics used by the reference.
    """
    K = A.shape[0]
    r = min(rank + oversample, K)
    # Full f32 products: a GPU's default TF32 contractions moved the K=300
    # factor by 1e-2 against the CPU's (chip_smoke.py's GPU-vs-CPU check).
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    omega = jax.random.normal(key, (K, r), dtype=A.dtype)
    Y = mm(A, omega)
    Q, _ = jnp.linalg.qr(Y)
    for _ in range(iters):
        Y = mm(A, mm(A, Q))
        Q, _ = jnp.linalg.qr(Y)
    B = mm(Q.T, mm(A, Q))                   # [r, r] symmetric projection
    B = 0.5 * (B + B.T)
    w, V = jnp.linalg.eigh(B)               # ascending
    order = jnp.argsort(-jnp.abs(w))[:rank]
    w = w[order]
    U = mm(Q, V[:, order])
    return U, jnp.abs(w)


def rsvd_half_factor(A: jax.Array, rank: int, key: jax.Array) -> jax.Array:
    """``X_half = U sqrt(s)`` — the reference's rounding input factor
    (``mmw.py:215-216``)."""
    U, s = randomized_symmetric_lowrank(A, rank, key)
    return U * jnp.sqrt(s)[None, :]
