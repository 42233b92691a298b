"""Fixed-iteration Lanczos extreme-eigenvalue estimation.

Compiled replacement for the reference's ARPACK ``eigsh(..., which='SA'/'LA')``
calls (duality-gap lower bound ``sim_src/alg/mmw.py:115``, X sanity check
``mmw.py:204``, spectral baseline ``sim_src/alg/sdp_solver.py:181``): a
jittable m-step Lanczos whose Ritz values bracket the spectrum.  No adaptive
convergence test — m is static; Ritz extreme values converge geometrically so
m ~ 32 is ample at reference scales.

The recurrence itself is the shared batched Lanczos of
:func:`sig_sdp_mmw_tpu.ops.expm.lanczos_tridiag` (one implementation serves
both the exponential action and the eigenvalue estimates).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from sig_sdp_mmw_tpu.ops.expm import lanczos_tridiag


def lanczos_extreme_eigs(matvec: Callable[[jax.Array], jax.Array], key: jax.Array,
                         n: int, m: int = 32, dtype=jnp.float32
                         ) -> Tuple[jax.Array, jax.Array]:
    """(lambda_min, lambda_max) Ritz estimates of a symmetric operator."""
    v = jax.random.normal(key, (n, 1), dtype=dtype)
    _, alphas, betas, _ = lanczos_tridiag(matvec, v, m, reorth=True)

    a = alphas[:, 0]
    b = betas[: m - 1, 0]
    T = jnp.diag(a) + jnp.diag(b, k=1) + jnp.diag(b, k=-1)
    theta = jnp.linalg.eigvalsh(T)
    return theta[0], theta[-1]
