"""Sparse (ELL) MMW solver — the scalable backend for 100k-1M-link graphs.

Same algorithm as :func:`sig_sdp_mmw_tpu.models.mmw.mmw_solve` (semantics of
``sim_src/alg/mmw.py:44-222``), with every O(K^2) dense object replaced by a
static-sparse representation:

* the accumulated loss matrix ``L_accu`` is IMPLICIT — a diagonal vector, a
  per-association-edge value vector and a per-row coefficient on the fixed
  S̃ pattern.  This works because each iteration's loss touches only
  (diagonal, association edges, scaled-S̃-rows) (``mmw.py:151-164``), so the
  accumulation stays on that fixed structure;
* the primal X is IMPLICIT — the sketch factor ``X_half`` plus its
  pattern-restricted edge values (diag, association edges, S̃ edges); the
  Lanczos matvec applies the implicit L in O(nnz * D);
* the averaged primal is accumulated per edge slot, and the final low-rank
  factor comes from operator-based randomized subspace iteration.

LOG_GAP parity (``mmw.py:79-117``): the UB is the max violation of the
averaged primal; the LB is ``K * lambda_min`` of the loss built from the
averaged dual weights, evaluated with fixed-iteration Lanczos through the
SAME implicit operator as the solve itself — no densification at any size.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from sig_sdp_mmw_tpu.core.ell import EllState
from sig_sdp_mmw_tpu.models.mmw import mmw_default_lanczos_m
from sig_sdp_mmw_tpu.ops.ell import ell_spmm, ell_edge_gather_dot
from sig_sdp_mmw_tpu.ops.expm import lanczos_expm_multiply
from sig_sdp_mmw_tpu.ops.lanczos import lanczos_extreme_eigs

_PREC = lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MMWEllOutput:
    X_half: jax.Array      # [Kp, rank_pad]
    ub_final: jax.Array    # scalar
    gap_log: jax.Array     # [nit, 2] (UB, LB) trajectory if log_gap else [0, 2]


def _q_apply(ell: EllState, edge_vals, V):
    """Symmetric association-edge operator: out[i] += sum_n
    edge_vals[q_eidx[i,n]] * V[q_cols[i,n]] — gather-only, no scatter."""
    ev = jnp.where(ell.q_mask, edge_vals[ell.q_eidx], 0.0)   # [Kp, degQ]
    return jnp.einsum("kn,knf->kf", ev, V[ell.q_cols], precision=_PREC)


def _edge_dots(ell: EllState, cols, X_half, inv_trace):
    """[Kp, deg] pattern-restricted Gram values <X_half[k], X_half[cols[k,d]]>
    computed slot-by-slot (no [Kp, deg, D] intermediate at large K)."""
    deg = cols.shape[1]

    def slot(d, acc):
        v = jnp.sum(X_half * X_half[cols[:, d]], axis=1) * inv_trace
        return acc.at[:, d].set(v)

    return lax.fori_loop(0, deg, slot,
                         jnp.zeros((ell.Kp, deg), X_half.dtype))


def mmw_solve_ell(ell: EllState, Z, *, nit: int, eta: float,
                  rank_radio: int = 2, D_pad: int, rank_pad: int,
                  key: jax.Array, lanczos_m: Optional[int] = None,
                  log_gap: bool = False, gap_lanczos_m: int = 32,
                  reorth: bool = True,
                  rsvd_iters: int = 3, bcsr=None,
                  factorize: bool = True,
                  spmm_row_chunk: Optional[int] = None,
                  carry_in=None, it_start=0, num_steps: Optional[int] = None,
                  return_carry: bool = False,
                  gram_mode: str = "auto") -> MMWEllOutput:
    """``bcsr``: optional :class:`sig_sdp_mmw_tpu.ops.bcsr.BcsrOperands`.
    When provided, EVERY per-iteration O(nnz*D) operation — the Lanczos
    matvecs, the association-edge operator and the pattern-restricted Gram
    accumulation — runs as block-sparse batched matmuls instead of row
    gathers (the block-native large-graph mode).  In that mode
    ``ell`` may be the full :class:`EllState` or the memory-lean
    :class:`sig_sdp_mmw_tpu.core.ell.EllSlim` (no O(K*deg) arrays on
    device).  ``spmm_row_chunk`` bounds the fused-SpMM gather transient at
    very large K (see :func:`sig_sdp_mmw_tpu.ops.bcsr.bcsr_spmm`).

    SEGMENTED execution (``carry_in`` / ``it_start`` / ``num_steps`` /
    ``return_carry``): the iteration loop can be split into several device
    executions that pass the solver carry (a pytree of device arrays)
    between them — run ``num_steps`` iterations starting at absolute index
    ``it_start`` from ``carry_in`` (or the fresh initial carry) and either
    return the raw carry (``return_carry=True``) or finish with the
    averaged-primal epilogue.  ``num_steps`` is STATIC (the fori trip
    count — a traced count would lower to a dynamic while_loop, which
    pessimizes the schedule); ``it_start`` may be traced, so ONE executable
    serves every segment.  Iteration indices are absolute, so a segmented
    run is BIT-IDENTICAL to a single-shot one (the PRNG streams fold in the
    absolute index).  Use cases: per-segment telemetry (the UB curve at
    segment boundaries, :func:`mmw_ell_ub_from_carry`), checkpointing, and
    keeping each device execution short at million-link scale, where one
    iteration takes seconds (tools/million_link.py runs 1M links in
    segments).  Whether the GPU still needs short executions is not
    measured yet.

    ``gram_mode`` — how the averaged primal accumulates on the S̃ pattern:

    * ``"block"``: a full [Kbr, Br, maxblk*Bc] f32 block accumulator,
      updated by ONE batched ``dot_general`` per iteration (zero gathers/
      scatters; the non-pattern positions inside stored blocks are masked
      once in the epilogue by the scattered symmetrization weights);
    * ``"edge"``: the O(nnz) per-edge vector via
      :func:`sig_sdp_mmw_tpu.ops.bcsr.bcsr_edge_gram_accum` — the
      million-link memory mode (the block accumulator would be GBs);
    * ``"auto"`` (default): block if the accumulator is <= 2 GiB."""
    Kp = ell.Kp
    K = ell.K
    E_pad = ell.E_pad
    use_bcsr = bcsr is not None
    is_slim = not hasattr(ell, "s_vals")
    if is_slim and not use_bcsr:
        raise ValueError("EllSlim is only valid with the BCSR backend")
    dtype = ell.h_max.dtype if is_slim else ell.s_vals.dtype
    Zf = jnp.asarray(Z, dtype)
    if use_bcsr:
        from sig_sdp_mmw_tpu.ops.bcsr import (BlockEll,
                                              bcsr_edge_gram_accum,
                                              bcsr_spmm, bcsr_spmm_transpose)

        nrows = bcsr.s_blocks.nrows
        padn = nrows - Kp
        Brow = bcsr.s_blocks.Brow
        Bcol = bcsr.s_blocks.B
        Kbr = bcsr.s_blocks.Kb
        Kbc = nrows // Bcol
        maxblk = bcsr.s_blocks.bcols.shape[1]
        maxblkQ = bcsr.q_bcols.shape[1]
        nnz_s = bcsr.nnz
        if gram_mode not in ("auto", "block", "edge"):
            raise ValueError(
                f"gram_mode must be 'auto', 'block' or 'edge', got {gram_mode!r}")
        if gram_mode == "auto":
            block_gram = Kbr * Brow * maxblk * Bcol * 4 <= 2 * 2**30
        else:
            block_gram = gram_mode == "block"

        def padV(V):
            return jnp.pad(V, ((0, padn), (0, 0))) if padn else V

        q_dtype = bcsr.s_blocks.blocks.dtype

        def q_block_vals(edge_vals):
            # Built in the block storage dtype (bfloat16 in lean mode —
            # same precision class as the S̃ blocks; the SpMM still
            # accumulates f32): halves a [Kbr, Br, maxblkQ, Bc] buffer that
            # lives across the whole Lanczos chain.
            flat = jnp.zeros((Kbr * maxblkQ * Brow * Bcol,), q_dtype)
            flat = flat.at[bcsr.q_pos].set(edge_vals[bcsr.q_eidx].astype(q_dtype))
            return flat.reshape(Kbr, Brow, maxblkQ, Bcol)

    if lanczos_m is None:
        lanczos_m = mmw_default_lanczos_m(eta, nit)

    # ---- preprocessing (mmw.py:26-41) -------------------------------------
    if is_slim:
        S_sum, row2 = ell.S_sum, ell.row2
    else:
        S_sum = jnp.sum(ell.s_vals, axis=1)
        row2 = jnp.sum(ell.s_vals * ell.s_vals, axis=1)
    norm_H = (jnp.sqrt(row2) * (Zf - 1.0) / (2.0 * Zf)
              + jnp.abs(ell.h_max / K - S_sum / (K * Zf)))
    norm_H = jnp.where(ell.mask & (norm_H > 0), norm_H, 1.0)

    # Sketch width D = Z*rank_radio (mmw.py:180), explicitly clamped to the
    # padded width: when the cap in _d_pad_for binds (Z*rank_radio > D_pad),
    # the sketch is deliberately truncated to D_pad columns — D ~ K Gaussian
    # probes already capture the full spectrum, so nothing is lost.
    D_act = jnp.minimum((Zf * rank_radio).astype(jnp.int32), D_pad)
    col_mask = (jnp.arange(D_pad) < D_act)[None, :]

    cF = 1.0 / (0.5 + 1.0 / (K * (Zf - 1.0)))

    def masked_softmax(eD, eF, eH):
        neg = jnp.asarray(-jnp.inf, dtype)
        eD = jnp.where(ell.mask, eD, neg)
        eF = jnp.where(ell.a_mask, eF, neg)
        eH = jnp.where(ell.mask, eH, neg)
        M = jnp.maximum(jnp.max(eD), jnp.maximum(jnp.max(eF), jnp.max(eH)))
        xD, xF, xH = jnp.exp(eD - M), jnp.exp(eF - M), jnp.exp(eH - M)
        den = jnp.sum(xD) + jnp.sum(xF) + jnp.sum(xH)
        return xD / den, xF / den, xH / den

    def violations(X_mdiag, xF, xH):
        eD = (X_mdiag - 1.0) / (1.0 - 1.0 / K)
        eF = (xF + 1.0 / (Zf - 1.0)) / (1.0 / (K * (Zf - 1.0)) + 0.5)
        eH = (xH * (Zf - 1.0) / Zf - (ell.h_max - S_sum / Zf)) / norm_H
        return eD, eF, eH

    def loss_pieces(YD, YF, YH):
        """Implicit loss L(Y) = diag(d) + sym-edge(f on Q) + sym(h∘S̃)
        (``mmw.py:146-164``), as the three coefficient vectors L_apply takes."""
        ld = (YD - jnp.sum(YD) / K) / (1.0 - 1.0 / K)
        lf_diag = jnp.sum(YF) / (K * (Zf - 1.0)) * cF
        coeff = YH / norm_H
        lh_diag = -jnp.sum((ell.h_max / K - S_sum / (K * Zf)) * coeff)
        d = jnp.where(ell.mask, ld + lf_diag + lh_diag, 0.0)
        f = YF * cF * 0.5
        h = coeff * (Zf - 1.0) / (2.0 * Zf)
        return d, f, h

    if use_bcsr:
        def s_matvec(V):
            return bcsr_spmm(bcsr.s_blocks, padV(V),
                             row_chunk=spmm_row_chunk)[:Kp]

        if bcsr.st_blocks is not None:
            def st_matvec(V):
                return bcsr_spmm(bcsr.st_blocks, padV(V),
                                 row_chunk=spmm_row_chunk)[:Kp]
        else:
            # Memory-lean mode: S̃ᵀ is not stored; scatter through S̃.
            def st_matvec(V):
                return bcsr_spmm_transpose(bcsr.s_blocks.bcols,
                                           bcsr.s_blocks.blocks,
                                           padV(V),
                                           row_chunk=spmm_row_chunk)[:Kp]
    else:
        def s_matvec(V):
            return ell_spmm(ell.s_cols, ell.s_vals, V)

        def st_matvec(V):
            return ell_spmm(ell.st_cols, ell.st_vals, V)

    def L_apply(d_accu, q_matvec, hrow, V):
        """Implicit L_accu @ V."""
        t = d_accu[:, None] * V
        t = t + q_matvec(V)
        t = t + hrow[:, None] * s_matvec(V)
        t = t + st_matvec(hrow[:, None] * V)
        return t

    # Initial Y: uniform over the valid constraints = softmax of zeros
    # (mmw.py:61-66); carried so the averaged dual matches the reference's
    # pre-update accumulation (mmw.py:78).
    y0D, y0F, y0H = masked_softmax(jnp.zeros((Kp,), dtype),
                                   jnp.zeros((E_pad,), dtype),
                                   jnp.zeros((Kp,), dtype))
    carry0 = dict(
        eaD=jnp.zeros((Kp,), dtype), eaF=jnp.zeros((E_pad,), dtype),
        eaH=jnp.zeros((Kp,), dtype),
        d_accu=jnp.zeros((Kp,), dtype), f_accu=jnp.zeros((E_pad,), dtype),
        hrow=jnp.zeros((Kp,), dtype),
        X_mdiag=jnp.where(ell.mask, 1.0, 0.0).astype(dtype),
        xF=jnp.zeros((E_pad,), dtype), xH=jnp.zeros((Kp,), dtype),
        avg_mdiag=jnp.zeros((Kp,), dtype), avg_F=jnp.zeros((E_pad,), dtype),
        avg_H=jnp.zeros((Kp,), dtype),
        y_D=y0D, y_F=y0F, y_H=y0H,
        ya_D=jnp.zeros((Kp,), dtype), ya_F=jnp.zeros((E_pad,), dtype),
        ya_H=jnp.zeros((Kp,), dtype),
        gap=jnp.zeros((nit if log_gap else 0, 2), dtype),
    )
    if use_bcsr and block_gram:
        # Averaged primal as a full f32 block accumulator (flat slot axis,
        # matching the fused dot_general output layout).
        carry0["avg_blocks"] = jnp.zeros((Kbr, Brow, maxblk * Bcol),
                                         jnp.float32)
    elif use_bcsr:
        # Averaged primal on the S̃ pattern as an O(nnz) per-edge vector
        # (last element = padding sink for bcsr_edge_gram_accum).
        carry0["avg_edge"] = jnp.zeros((nnz_s + 1,), dtype)
    else:
        carry0["s_edge"] = jnp.zeros(ell.s_cols.shape, dtype)
        carry0["st_edge"] = jnp.zeros(ell.st_cols.shape, dtype)
        carry0["avg_s"] = jnp.zeros(ell.s_cols.shape, dtype)
        carry0["avg_st"] = jnp.zeros(ell.st_cols.shape, dtype)

    def iteration(i, c):
        # Averaging (pre-update; mmw.py:77).
        avg_mdiag = c["avg_mdiag"] + c["X_mdiag"]
        avg_F = c["avg_F"] + c["xF"]
        avg_H = c["avg_H"] + c["xH"]
        if not use_bcsr:
            avg_s = c["avg_s"] + c["s_edge"]
            avg_st = c["avg_st"] + c["st_edge"]

        # Averaged dual weights (pre-update, mmw.py:78).
        ya_D = c["ya_D"] + c["y_D"]
        ya_F = c["ya_F"] + c["y_F"]
        ya_H = c["ya_H"] + c["y_H"]

        gap = c["gap"]
        if log_gap:
            n = jnp.asarray(i + 1, dtype)
            eD, eF, eH = violations(avg_mdiag / n, avg_F / n, avg_H / n)
            neg = jnp.asarray(-jnp.inf, dtype)
            u = jnp.max(jnp.maximum(
                jnp.max(jnp.where(ell.mask, eD, neg)),
                jnp.maximum(jnp.max(jnp.where(ell.a_mask, eF, neg)),
                            jnp.max(jnp.where(ell.mask, eH, neg)))))
            # LB = K * lambda_min of the averaged loss (mmw.py:96-116),
            # through the SAME implicit operator the solve uses.
            d_bar, f_bar, h_bar = loss_pieces(ya_D / n, ya_F / n, ya_H / n)
            if use_bcsr:
                fbar_blocks = q_block_vals(f_bar)

                def q_matvec_bar(V):
                    return bcsr_spmm(BlockEll(bcols=bcsr.q_bcols,
                                              blocks=fbar_blocks,
                                              nrows=nrows), padV(V))[:Kp]
            else:
                def q_matvec_bar(V):
                    return _q_apply(ell, f_bar, V)

            lkey = jax.random.fold_in(key, 2 * nit + 7 + i)
            lam_min, _ = lanczos_extreme_eigs(
                lambda V: L_apply(d_bar, q_matvec_bar, h_bar, V), lkey, Kp,
                m=gap_lanczos_m, dtype=dtype)
            gap = lax.dynamic_update_index_in_dim(
                gap, jnp.stack([u, lam_min * K]), i, axis=0)

        # Dual (mmw.py:126-139).
        eD, eF, eH = violations(c["X_mdiag"], c["xF"], c["xH"])
        eaD = c["eaD"] + eta * eD
        eaF = c["eaF"] + eta * jnp.where(ell.a_mask, eF, 0.0)
        eaH = c["eaH"] + eta * eH
        YD, YF, YH = masked_softmax(eaD, eaF, eaH)

        # Loss accumulation on the implicit structure (mmw.py:146-167).
        ld_d, lf_f, lh_h = loss_pieces(YD, YF, YH)
        d_accu = c["d_accu"] - eta * ld_d
        f_accu = c["f_accu"] - eta * lf_f
        hrow = c["hrow"] - eta * lh_h

        if use_bcsr:
            qvals = q_block_vals(f_accu)

            def q_matvec(V):
                return bcsr_spmm(BlockEll(bcols=bcsr.q_bcols, blocks=qvals,
                                          nrows=nrows), padV(V))[:Kp]
        else:
            def q_matvec(V):
                return _q_apply(ell, f_accu, V)

        # Primal (mmw.py:172-194).
        gkey = jax.random.fold_in(key, i)
        G = jax.random.normal(gkey, (Kp, D_pad), dtype)
        G = jnp.where(col_mask & ell.mask[:, None], G, 0.0)
        rn = jnp.linalg.norm(G, axis=1, keepdims=True)
        G = jnp.where(rn > 0, G / jnp.where(rn > 0, rn, 1.0), 0.0)

        X_half, _ = lanczos_expm_multiply(
            lambda V: 0.5 * L_apply(d_accu, q_matvec, hrow, V), G,
            m=lanczos_m, reorth=reorth, small_method="taylor_ss",
            norm_bound=eta * nit)

        md = jnp.sum(X_half * X_half, axis=1)
        X_trace = jnp.sum(md) / K
        inv_tr = 1.0 / X_trace
        X_mdiag = jnp.where(ell.mask, md * inv_tr, 0.0)
        xF = jnp.where(ell.a_mask,
                       ell_edge_gather_dot(ell.a_i, ell.a_j, X_half) * inv_tr,
                       0.0)
        W = s_matvec(X_half)
        xH = jnp.sum(X_half * W, axis=1) * inv_tr

        out = dict(eaD=eaD, eaF=eaF, eaH=eaH, d_accu=d_accu, f_accu=f_accu,
                   hrow=hrow, X_mdiag=X_mdiag, xF=xF, xH=xH,
                   avg_mdiag=avg_mdiag, avg_F=avg_F, avg_H=avg_H,
                   y_D=YD, y_F=YF, y_H=YH,
                   ya_D=ya_D, ya_F=ya_F, ya_H=ya_H, gap=gap)
        if use_bcsr and block_gram:
            # Averaged Gram via ONE batched dot_general straight into the
            # block accumulator — no per-edge gathers or scatters.  Non-pattern
            # positions inside stored blocks accumulate garbage that the
            # epilogue's weight mask zeroes.  The i<nit-1 gate excludes the
            # final X (mmw.py:77 accumulates pre-update; X_0=I contributes
            # 0 off-diagonal).
            Xp = padV(X_half)
            Xr = Xp.reshape(Kbr, Brow, D_pad)
            Xc = Xp.reshape(Kbc, Bcol, D_pad)
            gate = jnp.where(i < nit - 1, 1.0, 0.0).astype(jnp.float32)
            R = Xc[bcsr.s_blocks.bcols].reshape(Kbr, maxblk * Bcol, D_pad)
            G = lax.dot_general(Xr, R,
                                dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                                precision=_PREC,
                                preferred_element_type=jnp.float32)
            out["avg_blocks"] = c["avg_blocks"] + (gate * inv_tr) * G
        elif use_bcsr:
            # Pattern-restricted Gram as block matmuls accumulated straight
            # onto the per-edge vector (no full [Kbr, maxblk, Br, Bc] Gram
            # buffer).  The average over t=0..nit-1 excludes the final X
            # (mmw.py:77 accumulates pre-update) and X_0=I contributes 0 on
            # the off-diagonal pattern, hence the i<nit-1 gate.
            Xp = padV(X_half)
            Xr = Xp.reshape(Kbr, Brow, D_pad)
            Xc = Xp.reshape(Kbc, Bcol, D_pad)
            gate = jnp.where(i < nit - 1, 1.0, 0.0).astype(dtype)
            out["avg_edge"] = bcsr_edge_gram_accum(
                bcsr.s_blocks.bcols, Xr, Xc, bcsr.g_src, bcsr.g_dst,
                c["avg_edge"], gate * inv_tr)
        else:
            out["s_edge"] = jnp.where(
                ell.s_vals != 0, _edge_dots(ell, ell.s_cols, X_half, inv_tr),
                0.0)
            out["st_edge"] = jnp.where(
                ell.st_vals != 0, _edge_dots(ell, ell.st_cols, X_half, inv_tr),
                0.0)
            out["avg_s"] = avg_s
            out["avg_st"] = avg_st
        return out

    if carry_in is not None:
        carry0 = carry_in
    nsteps = nit if num_steps is None else num_steps
    base = jnp.asarray(it_start, jnp.int32)
    c = lax.fori_loop(0, nsteps, lambda j, cc: iteration(base + j, cc),
                      carry0)
    if return_carry:
        return c

    # ---- final UB + operator-based factorization (mmw.py:202-222) ---------
    avg_mdiag = c["avg_mdiag"] / nit
    avg_F = c["avg_F"] / nit
    avg_H = c["avg_H"] / nit
    eD, eF, eH = violations(avg_mdiag, avg_F, avg_H)
    neg = jnp.asarray(-jnp.inf, dtype)
    ub_final = jnp.max(jnp.maximum(
        jnp.max(jnp.where(ell.mask, eD, neg)),
        jnp.maximum(jnp.max(jnp.where(ell.a_mask, eF, neg)),
                    jnp.max(jnp.where(ell.mask, eH, neg)))))

    if not factorize:
        # Memory-bisection / telemetry mode: skip the averaged-primal
        # factorization (the epilogue) entirely.
        return MMWEllOutput(X_half=jnp.zeros((Kp, rank_pad), dtype),
                            ub_final=ub_final, gap_log=c["gap"])

    if use_bcsr and block_gram:
        # The accumulator already IS the block operator; one elementwise
        # mask by the scattered symmetrization weights (zero at non-pattern
        # positions) both symmetrizes and masks.
        wflat = jnp.zeros((Kbr * maxblk * Brow * Bcol,), jnp.float32)
        wflat = wflat.at[bcsr.s_pos].set(bcsr.w_edge.astype(jnp.float32))
        wavg = (c["avg_blocks"].reshape(Kbr, Brow, maxblk, Bcol) / nit
                * wflat.reshape(Kbr, Brow, maxblk, Bcol)).astype(q_dtype)
        q_avg = q_block_vals(avg_F)
    elif use_bcsr:
        # Scatter the symmetrization-weighted averaged edge values back into
        # a block operator (the transient full block array exists only here,
        # once, not inside the iteration loop).  Stored in the block dtype
        # (bfloat16 in lean mode): at million-link scale the f32 version of
        # this single buffer is 3+ GB — a major piece of the K=750k OOM.
        avg_vals = (c["avg_edge"][:nnz_s] / nit) * bcsr.w_edge.astype(dtype)
        flat = jnp.zeros((Kbr * maxblk * Brow * Bcol,), q_dtype)
        wavg = flat.at[bcsr.s_pos].set(avg_vals.astype(q_dtype)).reshape(
            Kbr, Brow, maxblk, Bcol)
        q_avg = q_block_vals(avg_F)

    if use_bcsr:
        avg_bell = BlockEll(bcols=bcsr.s_blocks.bcols, blocks=wavg,
                            nrows=nrows)
        q_bell = BlockEll(bcols=bcsr.q_bcols, blocks=q_avg, nrows=nrows)

        def X_avg_apply(V):
            Vp = padV(V)
            t = avg_mdiag[:, None] * V
            t = t + bcsr_spmm(q_bell, Vp)[:Kp]
            t = t + bcsr_spmm(avg_bell, Vp, row_chunk=spmm_row_chunk)[:Kp]
            t = t + bcsr_spmm_transpose(bcsr.s_blocks.bcols, wavg, Vp,
                                        row_chunk=spmm_row_chunk)[:Kp]
            return t
    else:
        avg_s = c["avg_s"] / nit * ell.s_xw
        avg_st = c["avg_st"] / nit * ell.st_xw

        def X_avg_apply(V):
            t = avg_mdiag[:, None] * V
            t = t + _q_apply(ell, avg_F, V)
            t = t + ell_spmm(ell.s_cols, avg_s, V)
            t = t + ell_spmm(ell.st_cols, avg_st, V)
            return t

    # Randomized subspace iteration on the implicit symmetric operator
    # (oversampled, like the dense rsvd path).
    r_ov = min(rank_pad + 8, Kp)
    rkey = jax.random.fold_in(key, nit + 1)
    Om = jax.random.normal(rkey, (Kp, r_ov), dtype)
    Qb = jnp.linalg.qr(X_avg_apply(Om))[0]
    for _ in range(rsvd_iters):
        Qb = jnp.linalg.qr(X_avg_apply(X_avg_apply(Qb)))[0]
    B = Qb.T @ X_avg_apply(Qb)
    B = 0.5 * (B + B.T)
    w, Vb = jnp.linalg.eigh(B)
    order = jnp.argsort(-jnp.abs(w))[:rank_pad]
    # (columns beyond rank_act are zeroed below, so oversampled columns drop)
    w_sel = jnp.abs(w[order])
    rank_act = jnp.minimum(K - 1, ((Zf - 1.0) * rank_radio)).astype(jnp.int32)
    keep = (jnp.arange(rank_pad) < rank_act)[None, :]
    X_half = jnp.where(keep, (Qb @ Vb[:, order]) * jnp.sqrt(w_sel)[None, :],
                       0.0)
    X_half = jnp.where(ell.mask[:, None], X_half, 0.0)

    return MMWEllOutput(X_half=X_half, ub_final=ub_final, gap_log=c["gap"])


def mmw_ell_ub_from_carry(ell, Z, carry, n):
    """Max constraint violation of the n-iteration AVERAGED primal, read
    straight from a segmented-run carry (the reference's LOG_GAP UB,
    ``mmw.py:79-95``) — lets a segmented driver log the convergence curve
    at segment boundaries for the cost of O(Kp + E) vector math.

    ``ell`` may be EllState or EllSlim; ``n`` may be traced."""
    dtype = carry["avg_mdiag"].dtype
    Zf = jnp.asarray(Z, dtype)
    K = ell.K
    if hasattr(ell, "s_vals"):
        S_sum = jnp.sum(ell.s_vals, axis=1)
        row2 = jnp.sum(ell.s_vals * ell.s_vals, axis=1)
    else:
        S_sum, row2 = ell.S_sum, ell.row2
    norm_H = (jnp.sqrt(row2) * (Zf - 1.0) / (2.0 * Zf)
              + jnp.abs(ell.h_max / K - S_sum / (K * Zf)))
    norm_H = jnp.where(ell.mask & (norm_H > 0), norm_H, 1.0)
    nf = jnp.asarray(n, dtype)
    avg_mdiag = carry["avg_mdiag"] / nf
    avg_F = carry["avg_F"] / nf
    avg_H = carry["avg_H"] / nf
    eD = (avg_mdiag - 1.0) / (1.0 - 1.0 / K)
    eF = (avg_F + 1.0 / (Zf - 1.0)) / (1.0 / (K * (Zf - 1.0)) + 0.5)
    eH = (avg_H * (Zf - 1.0) / Zf - (ell.h_max - S_sum / Zf)) / norm_H
    neg = jnp.asarray(-jnp.inf, dtype)
    return jnp.max(jnp.maximum(
        jnp.max(jnp.where(ell.mask, eD, neg)),
        jnp.maximum(jnp.max(jnp.where(ell.a_mask, eF, neg)),
                    jnp.max(jnp.where(ell.mask, eH, neg)))))


from sig_sdp_mmw_tpu.utils.stats import StatsObject as _StatsObject


class MMWEll(_StatsObject):
    """Reference-compatible solver object over the sparse ELL state — the
    large-K counterpart of :class:`sig_sdp_mmw_tpu.models.mmw.MMW` (reference
    ``mmw.py:12-24``), pluggable into
    :class:`sig_sdp_mmw_tpu.models.search.BinarySearchRelaxation`.

    ``Z`` is traced, so the whole binary search shares one executable per
    (Kp, D_pad) bucket.  ``use_bcsr=True`` runs every hot op as block-sparse
    batched matmuls (build operands once per state via :meth:`prepare`).
    """

    def __init__(self, nit: int = 100, rank_radio: int = 2,
                 eta: float = 0.1, log_gap: bool = False,
                 lanczos_m: Optional[int] = None, seed: int = 0,
                 use_bcsr: bool = False, nattempt: int = 10):
        self.nit = nit
        self.rank_radio = rank_radio
        self.eta = eta
        self.log_gap = log_gap
        self.lanczos_m = lanczos_m
        self.use_bcsr = use_bcsr
        self.nattempt = nattempt
        self._key = jax.random.PRNGKey(seed)
        self._ncall = 0
        self._jit_cache = {}
        self._bcsr = None
        self._bcsr_for = None   # weakref to the EllState prepare() ran for
        # Sticky sketch-width bucket: the first probe of a binary search pins
        # the (D_pad, rank_pad) bucket so every later (smaller-Z) probe reuses
        # the same executable — no mid-search recompiles (r2 weak #1).  Only
        # the rare "shift window up" case can grow it (one extra compile).
        # Pins hold a WEAKREF to the state (not id(): CPython reuses ids
        # after GC, which would let a new state inherit a stale pin); a dead
        # ref simply never matches, so pins die with their state.
        self._pinned = None   # (weakref(state), D_pad, rank_pad)
        self._pinned_zpad = None   # (weakref(state), rounding Z_pad bucket)

    @staticmethod
    def _pin_matches(pin, ell) -> bool:
        return pin is not None and pin[0]() is ell

    def prepare(self, ell: EllState, S_csr=None, Q_csr=None, block: int = 128,
                **bcsr_kw):
        """Precompute BCSR operands for a state (once per instance)."""
        if self.use_bcsr:
            from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state
            if S_csr is None:
                raise ValueError("use_bcsr=True needs the scipy (S, Q) pair")
            # Block rows are padded to the block lcm internally (>= ell.Kp);
            # mmw_solve_ell pads/crops V between the two layouts.
            self._bcsr = bcsr_operands_from_state(S_csr, Q_csr, block=block,
                                                  **bcsr_kw)
            if self._bcsr.s_blocks.nrows < ell.Kp:
                raise ValueError(
                    f"BCSR row padding ({self._bcsr.s_blocks.nrows}) is "
                    f"smaller than the EllState padding (Kp={ell.Kp}); "
                    f"rebuild the EllState with the default pad_rows_to or "
                    f"pass pad_rows_to={ell.Kp} to bcsr_operands_from_state")
            self._bcsr_for = weakref.ref(ell)
        return self

    def _d_pad_for(self, ell: EllState, Z: int):
        # Sketch width tracks the probe's Z (D = Z*rank_radio active columns,
        # mmw.py:180), bucketed to powers of two so a binary search compiles
        # O(log) executables instead of one per mid — and never pays the
        # window upper bound's width on every probe.
        need = max(32, int(Z) * self.rank_radio)
        D_pad = 1 << (need - 1).bit_length()
        # Cap at Kp-1 rounded down to a lane multiple (a wider sketch than the
        # matrix order buys nothing); for tiny Kp<=16 fall back to Kp-1 rather
        # than a 16-wide sketch that would exceed the matrix order.
        cap = ((ell.Kp - 1) // 16) * 16
        if cap == 0:
            cap = max(ell.Kp - 1, 1)
        if D_pad > cap:
            D_pad = cap  # binds only when Z*rank_radio ~ K; see D_act clamp
        return D_pad, min(D_pad, ell.Kp - 1)

    def _solver_fn(self, D_pad: int, rank_pad: int):
        sig = (D_pad, rank_pad, self.nit, self.eta, self.rank_radio,
               self.lanczos_m, self.log_gap, self.use_bcsr)
        if sig not in self._jit_cache:
            def fn(ell, Z, key, bcsr):
                return mmw_solve_ell(ell, Z, nit=self.nit, eta=self.eta,
                                     rank_radio=self.rank_radio, D_pad=D_pad,
                                     rank_pad=rank_pad, key=key,
                                     lanczos_m=self.lanczos_m,
                                     log_gap=self.log_gap, bcsr=bcsr)
            self._jit_cache[sig] = jax.jit(fn)
        return self._jit_cache[sig]

    def run_with_state(self, bs_iteration: int, Z: int, ell: EllState,
                       D_pad: Optional[int] = None):
        import numpy as np
        tic = self._get_tic()
        if D_pad is None:
            D_pad, rank_pad = self._d_pad_for(ell, Z)
            # Sticky bucket: reuse (grow only if needed) the bucket pinned by
            # this state's first probe, so a descending binary search never
            # recompiles (a smaller Z in a wider bucket is exact — D_act
            # masks the extra columns).
            if self._pin_matches(self._pinned, ell):
                D_pad = max(D_pad, self._pinned[1])
                rank_pad = max(rank_pad, self._pinned[2])
            self._pinned = (weakref.ref(ell), D_pad, rank_pad)
        else:
            rank_pad = min(D_pad, ell.Kp - 1)
        bcsr = self._bcsr if (self.use_bcsr and self._bcsr_for is not None
                              and self._bcsr_for() is ell) else None
        if self.use_bcsr and bcsr is None:
            raise RuntimeError("use_bcsr=True: call prepare(ell, S, Q) first")
        fn = self._solver_fn(D_pad, rank_pad)
        self._ncall += 1
        key = jax.random.fold_in(self._key, self._ncall)
        out = fn(ell, float(Z), key, bcsr)
        tim = self._get_tim(tic, sync=out.X_half)
        self._add_np_log("mmw_all_it", bs_iteration,
                         np.array([Z, ell.K, tim]))
        self.last_output = out
        return True, out.X_half

    def rounding(self, Z: int, gX, ell: EllState, nattempt: Optional[int] = None):
        from sig_sdp_mmw_tpu.models.rounding_ell import (
            default_z_pad_ell, rounding_ell)
        # Sticky Z_pad bucket (same trick as the sketch-width pin above): the
        # first probe of a binary search pins the rounding's slot padding, so
        # every later (smaller-Z) probe reuses one rounding executable —
        # compile-once per search instead of per pow2 bucket.  A smaller Z in
        # a wider pad is exact (slots >= Z are masked).
        z_pad = default_z_pad_ell(ell, Z)
        if self._pin_matches(self._pinned_zpad, ell):
            z_pad = max(z_pad, self._pinned_zpad[1])
        self._pinned_zpad = (weakref.ref(ell), z_pad)
        self._ncall += 1
        key = jax.random.fold_in(self._key, 10_000_000 + self._ncall)
        return rounding_ell(Z, gX, ell, key, Z_pad=z_pad,
                            nattempt=nattempt or self.nattempt)
