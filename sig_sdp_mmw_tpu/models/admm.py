"""Exact SDP baseline via ADMM splitting — the oracle role of cvxpy+SCS.

The reference's exact baseline (``sim_src/alg/sdp_solver.py:115-163``) hands
the feasibility SDP

    X >> 0,  diag(X) = 1,  X_ij <= -1/(Z-1) on associated pairs,
    sum_j S̃_kj X_kj (Z-1)/Z <= h_max_k - S_sum_k/Z

to the SCS interior C library.  cvxpy/SCS is not available in this image, so
the oracle is re-built in JAX as a fully jitted ADMM consensus split

    minimize  I_PSD(X) + I_poly(Y)   s.t.  X = Y

with exact PSD projection (dense ``eigh``) and a polyhedral step that applies
the affine/inequality constraints: diagonal pinning, association clipping and
Cimmino-averaged halfspace corrections for the interference rows.  Like SCS
under ``max_iters=nit`` (``sdp_solver.py:127``), a finite iteration budget
yields an approximately feasible X; the downstream randomized rounding is
identical.  The final factor mirrors the reference's rank-trimmed SVD
(``sdp_solver.py:130-132``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sig_sdp_mmw_tpu.core.preprocess import build_mmw_operands
from sig_sdp_mmw_tpu.core.problem import SigState
from sig_sdp_mmw_tpu.models.base import SDPSolverBase
from sig_sdp_mmw_tpu.utils.stats import StatsObject

_PREC = lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("nit", "rank_pad", "rank_radio"))
def admm_sdp_solve(state: SigState, Z, *, nit: int, rank_pad: int,
                   rank_radio: int = 2):
    """Consensus ADMM over four constraint blocks, each with an EXACT
    Euclidean projection — the inexactness that stalls a naive two-block
    Douglas-Rachford split is avoided by giving every family its own
    consensus copy:

    1. symmetric PSD cone (eigh clip of the symmetrized copy — the nearest
       symmetric-PSD matrix to an arbitrary square matrix);
    2. ``diag(X) = 1`` (affine: replace the diagonal);
    3. association cap ``X_ij <= -1/(Z-1)`` (pointwise min, both triangles);
    4. interference row halfspaces ``<St_k, X_k> <= c_k`` — with symmetry
       held by block 1, row constraints touch disjoint coordinates, so the
       joint projection is the per-row halfspace formula, exactly.

    Consensus ADMM over an intersection of closed convex sets converges to a
    feasible point whenever the SDP is feasible, which is the oracle property
    the binary search consumes (reference ``sdp_solver.py:115-163``).
    """
    Kp = state.Kp
    K = state.K
    dtype = state.S.dtype
    Zf = jnp.asarray(Z, dtype)
    op = build_mmw_operands(state, Zf)

    eyeb = jnp.eye(Kp, dtype=bool)
    m2 = op.mask[:, None] & op.mask[None, :]
    asso = (state.Q != 0) & m2
    fbound = -1.0 / (Zf - 1.0)
    diag_target = jnp.where(op.mask, 1.0, 0.0)

    St = op.St
    St_norm2 = jnp.maximum(jnp.sum(St * St, axis=1), 1e-12)   # [Kp]
    c_H = (op.h_max - op.S_sum / Zf) * Zf / (Zf - 1.0)        # row budgets

    def proj_psd(X):
        Xs = 0.5 * (X + X.T)
        w, V = jnp.linalg.eigh(Xs)
        w = jnp.maximum(w, 0.0)
        return (V * w[None, :]) @ V.T

    def proj_diag(X):
        return jnp.where(eyeb, diag_target[None, :] * jnp.eye(Kp, dtype=dtype),
                         X)

    def proj_asso(X):
        return jnp.where(asso, jnp.minimum(X, fbound), X)

    def proj_interf(X):
        v = jnp.sum(St * X, axis=1)                            # [Kp]
        excess = jnp.maximum(v - c_H, 0.0)
        return X - (excess / St_norm2)[:, None] * St

    projs = (proj_psd, proj_diag, proj_asso, proj_interf)
    nb = len(projs)

    X0 = jnp.where(eyeb, 1.0, 0.0) * diag_target[None, :]
    X0 = X0.astype(dtype)

    def body(i, carry):
        Xbar, Us = carry
        Zs = [p(Xbar - U) for p, U in zip(projs, Us)]
        Xbar_new = sum(Zi + Ui for Zi, Ui in zip(Zs, Us)) / nb
        Xbar_new = jnp.where(m2, Xbar_new, 0.0)
        Us_new = tuple(U + Zi - Xbar_new for U, Zi in zip(Us, Zs))
        return Xbar_new, Us_new

    Us0 = tuple(jnp.zeros((Kp, Kp), dtype) for _ in range(nb))
    Xbar, _ = lax.fori_loop(0, nit, body, (X0, Us0))

    X_final = proj_psd(Xbar)
    # Rank-trimmed factor (sdp_solver.py:130-132) via eigh (X ~ PSD here).
    w, V = jnp.linalg.eigh(X_final)
    order = jnp.argsort(-jnp.abs(w))[:rank_pad]
    w_sel = jnp.abs(w[order])
    # min(K, (Z-1)*rank_radio) exactly as the reference (sdp_solver.py:131).
    rank_act = jnp.minimum(jnp.asarray(K, jnp.int32),
                           ((Zf - 1.0) * rank_radio).astype(jnp.int32))
    keep = (jnp.arange(rank_pad) < rank_act)[None, :]
    X_half = jnp.where(keep, V[:, order] * jnp.sqrt(w_sel)[None, :], 0.0)
    X_half = jnp.where(op.mask[:, None], X_half, 0.0)
    return X_half, X_final


class ADMMSDPSolver(SDPSolverBase, StatsObject):
    """Drop-in for the reference ``admm_sdp_solver`` (``sdp_solver.py:115``)."""

    def __init__(self, nit: int = 100, rank_radio: int = 2, alpha: float = 1.0):
        SDPSolverBase.__init__(self, nit=nit, rank_radio=rank_radio, alpha=alpha)

    def run_with_state(self, bs_iteration: int, Z: int, state: SigState):
        ps_tic = self._get_tic()
        _, ub = state.degree_bounds()
        rank_pad = min(((max(Z, ub) * self.rank_radio + 15) // 16) * 16,
                       state.Kp - 1)
        tim = self._get_tim(ps_tic)
        self._add_np_log("admm_problem_setup", bs_iteration,
                         np.array([Z, state.K, tim]))

        tic = self._get_tic()
        X_half, _ = admm_sdp_solve(state, float(Z), nit=self.nit,
                                   rank_pad=rank_pad,
                                   rank_radio=self.rank_radio)
        tim = self._get_tim(tic, sync=X_half)
        self._add_np_log("admm_solve", bs_iteration,
                         np.array([Z, state.K, tim]))
        return True, X_half
