"""Action of the matrix exponential — the MMW solver's dominant cost.

The reference computes ``expm_multiply(L/2, randn(K, D))`` with scipy's
Al-Mohy–Higham algorithm (``sim_src/alg/mmw.py:224-229``), whose adaptive
1-norm estimation and scaling/squaring is data-dependent control flow that
cannot be compiled.  The replacement here is a **batched Lanczos
(Krylov) approximation with a fixed iteration count**:

* all D sketch columns run their Lanczos recurrences simultaneously, so each
  step is one K×K (or sparse) matvec applied to a [K, D] block — one
  matmul, not D sequential solves;
* the m×m tridiagonal exponentials are computed via batched ``eigh`` in the
  tiny Krylov space;
* results carry a **global log-scale**: ``expm(A) @ V = exp(sigma) * F``.
  MMW only uses the trace-normalized Gibbs state ``exp(L)/tr`` which is
  invariant to the scale, so ``sigma`` never needs exponentiating — this is
  what makes fp32 viable at large ``||L||`` where the true exponential
  overflows.

Krylov error decays like ``exp(-m^2 / (4 * ||A||))`` once ``m > ||A||``
(spectral-interval form), so a static ``m`` chosen from the analytic bound
``||L_accu/2|| <= eta * nit`` (loss terms are constraint-normalized,
``mmw.py:39``) gives full accuracy with no data-dependent branching.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

# Full f32 products: with default precision a GPU runs f32 contractions in
# TF32 (10-bit mantissa), which moved the K=300 solution measurably away
# from the CPU's (chip_smoke.py's GPU-vs-CPU check).
_HIGHEST = jax.lax.Precision.HIGHEST

MatVec = Callable[[jax.Array], jax.Array]  # [K, D] -> [K, D], symmetric A


def default_lanczos_iters(norm_bound: float) -> int:
    """Static Krylov dimension for a spectral-norm bound (see module doc)."""
    import math

    m = int(math.ceil(1.25 * norm_bound + 8.0 * math.sqrt(max(norm_bound, 1.0))))
    return max(8, min(m, 96))


def _expm_e1_batched_sym(T: jax.Array, norm_bound: float,
                         taylor_order: int = 12) -> Tuple[jax.Array, jax.Array]:
    """``exp(T - sigma I) @ e1`` for a batch of small symmetric matrices.

    Matmul-only alternative to batched ``eigh`` (whose QR iterations are
    sequential, data-dependent work): a *static* scaling-and-squaring with a global
    Gershgorin shift.  ``norm_bound`` is a static spectral-norm bound that
    fixes the squaring count at trace time — no data-dependent control flow.

    Returns (y [D, m], sigma): true value is ``exp(sigma) * y``.
    """
    import math as _math

    D, m, _ = T.shape
    # Global shift: largest Gershgorin upper bound across the batch.
    diag = jnp.diagonal(T, axis1=-2, axis2=-1)
    radii = jnp.sum(jnp.abs(T), axis=-1) - jnp.abs(diag)
    sigma = jnp.max(diag + radii)
    M = T - sigma * jnp.eye(m, dtype=T.dtype)[None]

    # Spectrum of M lies in [-2*norm_bound, 0]; scale so ||M/2^s|| <= ~1.
    s = max(0, int(_math.ceil(_math.log2(max(2.0 * norm_bound, 1.0)))))
    Ms = M / (2.0 ** s)

    E = jnp.eye(m, dtype=T.dtype)[None] + Ms
    term = Ms
    for p in range(2, taylor_order + 1):
        term = jnp.einsum("dij,djk->dik", term, Ms,
                          precision=jax.lax.Precision.HIGHEST) / p
        E = E + term
    for _ in range(s):
        E = jnp.einsum("dij,djk->dik", E, E,
                       precision=jax.lax.Precision.HIGHEST)
    return E[:, :, 0], sigma


def lanczos_tridiag(matvec: MatVec, V: jax.Array, m: int, reorth: bool = True
                    ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """The shared m-step batched Lanczos recurrence.

    Runs all D columns of V simultaneously (each matvec is a [K, D] block
    apply) and returns ``(Q, alphas, betas, beta0)``: the Krylov bases
    [m, K, D], the tridiagonal coefficients [m, D] (betas[j] couples q_j and
    q_{j+1}), and the initial column norms [D].  Consumed by
    :func:`lanczos_expm_multiply` (action of the exponential) and
    :func:`sig_sdp_mmw_tpu.ops.lanczos.lanczos_extreme_eigs` (Ritz extreme
    eigenvalues) — one recurrence, two small-space post-processings.
    """
    K, D = V.shape
    dtype = V.dtype

    def _safe_div(x, d):
        # Divide columns by d, but NEVER divide by a non-positive value even
        # in the dead branch of a select — XLA may rewrite x/max(d, tiny)
        # into x * rcp(...) patterns that breed NaN/Inf for zero columns.
        d_ok = d > 0
        den = jnp.where(d_ok, d, 1.0)
        return jnp.where(d_ok[None, :], x / den[None, :], 0.0)

    beta0 = jnp.linalg.norm(V, axis=0)                        # [D]
    q0 = _safe_div(V, beta0)

    Q0 = jnp.zeros((m, K, D), dtype).at[0].set(q0)

    def body(carry, j):
        Q, q_prev, q, beta_prev = carry
        w = matvec(q) - beta_prev[None, :] * q_prev
        alpha = jnp.sum(q * w, axis=0)                        # [D]
        w = w - alpha[None, :] * q
        if reorth:
            proj = jnp.einsum("mkd,kd->md", Q, w,
                              precision=_HIGHEST)             # [m, D]
            proj = jnp.where((jnp.arange(m) <= j)[:, None], proj, 0.0)
            w = w - jnp.einsum("mkd,md->kd", Q, proj, precision=_HIGHEST)
        beta = jnp.linalg.norm(w, axis=0)                     # [D]
        # Happy breakdown: invariant subspace found -> stop extending.
        alive = beta > 1e-8 * jnp.maximum(beta0, 1e-20)
        beta_out = jnp.where(alive, beta, 0.0)
        q_next = _safe_div(w, beta_out)
        # In-place-aliasable slot write (a full-Q jnp.where select forces a
        # second [m, K, D] buffer in the scan carry — at K=750k that is an
        # extra 1+ GB of XLA temp).  The final step (j = m-1) has no slot
        # to write — j+1 would clamp to m-1 and overwrite Q[m-1] — so the
        # written value is gated to the existing slot content there.
        idx = jnp.minimum(j + 1, m - 1)
        cur = jax.lax.dynamic_index_in_dim(Q, idx, axis=0, keepdims=False)
        val = jnp.where(j + 1 < m, q_next, cur)
        Q = jax.lax.dynamic_update_index_in_dim(Q, val, idx, axis=0)
        return (Q, q, q_next, beta_out), (alpha, beta_out)

    init = (Q0, jnp.zeros_like(q0), q0, jnp.zeros((D,), dtype))
    (Q, _, _, _), (alphas, betas) = jax.lax.scan(body, init, jnp.arange(m))
    return Q, alphas, betas, beta0


def lanczos_expm_multiply(matvec: MatVec, V: jax.Array, m: int,
                          reorth: bool = True,
                          small_method: str = "eigh",
                          norm_bound: float = None) -> Tuple[jax.Array, jax.Array]:
    """``expm(A) @ V ~= exp(sigma) * F`` via m-step batched Lanczos.

    Args:
      matvec: applies the symmetric operator A to a [K, D] block.
      V: [K, D] block of vectors.
      m: static Krylov dimension.
      reorth: full re-orthogonalization against the stored basis (cheap at
        these sizes; essential in fp32).

    Returns:
      (F, sigma): F is [K, D]; sigma is the scalar log-scale, i.e.
      ``expm(A) @ V = exp(sigma) * F`` (same sigma for every column, so
      cross-column inner products of F are consistently scaled).
    """
    Q, alphas, betas, beta0 = lanczos_tridiag(matvec, V, m, reorth=reorth)

    a = alphas.T                                              # [D, m]
    b = betas.T[:, : m - 1]                                   # [D, m-1]
    T = jax.vmap(jnp.diag)(a)                                 # [D, m, m]
    off = jax.vmap(lambda x: jnp.diag(x, k=1))(b)
    T = T + off + jnp.swapaxes(off, -1, -2)

    if small_method == "pade":          # legacy alias for the pre-rename path
        small_method = "taylor_ss"
    if small_method not in ("taylor_ss", "eigh"):
        raise ValueError(
            f"small_method must be 'taylor_ss' or 'eigh', got {small_method!r}")
    if small_method == "taylor_ss":
        # Matmul-only small expm: static Taylor scaling-and-squaring (see
        # _expm_e1_batched_sym).
        nb = norm_bound if norm_bound is not None else float(m)
        coeff, sigma = _expm_e1_batched_sym(T, nb)
    else:
        theta, U = jnp.linalg.eigh(T)                         # [D, m], [D, m, m]
        sigma = jnp.max(theta)                                # global log-scale
        w1 = U[:, 0, :]                                       # e1^T U -> [D, m]
        coeff = jnp.einsum("dmn,dn,dn->dm", U, jnp.exp(theta - sigma), w1,
                           precision=_HIGHEST)
    coeff = coeff * beta0[:, None]
    F = jnp.einsum("mkd,dm->kd", Q, coeff, precision=_HIGHEST)
    return F, sigma


def taylor_expm_multiply(matvec: MatVec, V: jax.Array, steps: int,
                         order: int = 12) -> jax.Array:
    """Reference-style validation path: ``(exp(A/steps))^steps V`` with a
    fixed-order truncated Taylor series per substep.  No log-scaling — only
    for small ``||A||`` cross-checks against the Lanczos path."""
    s = float(steps)

    def substep(V, _):
        term = V
        acc = V
        for p in range(1, order + 1):
            term = matvec(term) / (s * p)
            acc = acc + term
        return acc, None

    out, _ = jax.lax.scan(substep, V, None, length=steps)
    return out
