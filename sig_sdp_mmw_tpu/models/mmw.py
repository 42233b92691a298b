"""Matrix-Multiplicative-Weights SDP feasibility solver — the framework core.

Compiled re-design of the reference solver (``sim_src/alg/mmw.py``): the
whole ``nit``-iteration dual/loss/primal loop is ONE jitted ``lax.fori_loop``
over a :class:`MMWCarry` pytree.  Faithful algorithm semantics
(``mmw.py:44-222``), hardware-native execution:

* scipy CSR mutations -> static dense masked arrays (ELL backend for the
  million-link scale lives in :mod:`sig_sdp_mmw_tpu.parallel`);
* ``scipy.sparse.linalg.expm_multiply`` (``mmw.py:228``) -> fixed-iteration
  batched-Lanczos :func:`sig_sdp_mmw_tpu.ops.expm.lanczos_expm_multiply`
  whose per-step cost is a [K,K]@[K,D] matmul, with a global log-scale so
  the trace-normalized Gibbs state is exact in fp32;
* ``Z`` is a TRACED scalar and the sketch width is padded to a static
  ``D_pad`` with masked columns, so one compilation serves every probe of the
  binary search over Z;
* the global numpy RNG (``mmw.py:226``) -> explicit PRNG keys folded per
  iteration: runs are replayable, including across device meshes;
* duality-gap telemetry (``mmw.py:79-117``) is computed on-device into a
  ``[nit, 2]`` buffer (UB = max averaged violation, LB = K*lambda_min of the
  averaged loss via fixed-iteration Lanczos).

Constraint system (``sdp_solver.py:153-161``, mirrored at ``mmw.py:126-134``):
  A_D: diag(X) = 1;  A_F: X_ij <= -1/(Z-1) on associated pairs;
  A_H: row-sums of S̃∘X bounded by the interference budget.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sig_sdp_mmw_tpu.core.preprocess import MMWOperands, build_mmw_operands
from sig_sdp_mmw_tpu.core.problem import SigState
from sig_sdp_mmw_tpu.models.base import SDPSolverBase
from sig_sdp_mmw_tpu.ops.expm import default_lanczos_iters, lanczos_expm_multiply
from sig_sdp_mmw_tpu.ops.lanczos import lanczos_extreme_eigs
from sig_sdp_mmw_tpu.ops.rsvd import randomized_symmetric_lowrank
from sig_sdp_mmw_tpu.utils.stats import StatsObject

_PREC = lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MMWOutput:
    X_half: jax.Array      # [Kp, rank_pad] final factor (masked cols beyond rank)
    ub_final: jax.Array    # max violation of the averaged X (scalar)
    gap_log: jax.Array     # [nit, 2] (UB, LB) if log_gap else [0, 2]
    X_avgd: jax.Array      # [Kp, Kp] averaged primal (diag included)


def _masked_softmax_3(eD, eF, eH, mD, mF, mH):
    """Softmax over the concatenation of three masked violation blocks
    (``mmw.py:136-139``); masked entries get zero weight."""
    neg = jnp.asarray(-jnp.inf, eD.dtype)
    eD = jnp.where(mD, eD, neg)
    eF = jnp.where(mF, eF, neg)
    eH = jnp.where(mH, eH, neg)
    M = jnp.maximum(jnp.max(eD), jnp.maximum(jnp.max(eF), jnp.max(eH)))
    xD, xF, xH = (jnp.exp(eD - M), jnp.exp(eF - M), jnp.exp(eH - M))
    den = jnp.sum(xD) + jnp.sum(xF) + jnp.sum(xH)
    return xD / den, xF / den, xH / den


def _violations(X_mdiag, X_offdi, op: MMWOperands, Z, K):
    """Constraint violations of a primal iterate (``mmw.py:126-134``)."""
    eD = (X_mdiag - 1.0) / (1.0 - 1.0 / K)
    eF = (X_offdi + 1.0 / (Z - 1.0)) / (1.0 / (K * (Z - 1.0)) + 0.5)
    AHX = jnp.sum(op.St * X_offdi, axis=1)
    eH = (AHX * (Z - 1.0) / Z - (op.h_max - op.S_sum / Z)) / op.norm_H
    return eD, eF, eH


def _loss_matrix(YD, YF, YH, op: MMWOperands, Z, K, Kp):
    """Dense loss L = LD + LF + LH for a dual weight vector (``mmw.py:146-164``)."""
    ld = (YD - jnp.sum(YD) / K) / (1.0 - 1.0 / K)                   # LD diagonal
    YF_m = 0.5 * (YF + YF.T)
    cF = 1.0 / (0.5 + 1.0 / (K * (Z - 1.0)))
    lf_diag = jnp.sum(YF) / (K * (Z - 1.0)) * cF
    LF = YF_m * cF
    coef = YH / op.norm_H
    Mh = coef[:, None] * op.St
    LH = (Mh + Mh.T) * (Z - 1.0) / (2.0 * Z)
    lh_diag = -jnp.sum((op.h_max / K - op.S_sum / (K * Z)) * coef)
    diag = ld + lf_diag + lh_diag * jnp.ones((Kp,), YD.dtype)
    diag = jnp.where(op.mask, diag, 0.0)
    return LF + LH + jnp.diag(diag)


def mmw_default_lanczos_m(eta: float, nit: int) -> int:
    """Krylov dimension default for the MMW Gibbs sketch.

    The worst-case bound ``||L_accu/2|| <= eta*nit`` is extremely loose in
    practice: per-iteration losses partially cancel as the primal adapts, and
    the trace-normalized Gibbs state only needs the action of exp on the
    dominant part of the spectrum.  Empirically (fixture + K=300 instances,
    nit up to 625) the final max-violation is bit-identical from m=8 to m=48;
    we keep a sqrt safety margin on top of that floor.  Override
    ``lanczos_m`` explicitly for exotic (eta, nit) regimes — the ``ub_final``
    telemetry will flag any quality loss.
    """
    return min(48, max(8, int(math.ceil(8 + 0.6 * math.sqrt(eta * nit)))))


def mmw_solve(state: SigState, Z, *, nit: int, eta: float, rank_radio: int = 2,
              D_pad: int, rank_pad: int, key: jax.Array,
              lanczos_m: Optional[int] = None, log_gap: bool = False,
              gap_lanczos_m: int = 32) -> MMWOutput:
    """Run the MMW dual/loss/primal loop; jit-compatible, Z may be traced.

    Static: nit, eta, rank_radio, D_pad, rank_pad, lanczos_m, log_gap.
    Traced: state arrays, Z, key.
    """
    Kp = state.Kp
    K = state.K
    dtype = state.S.dtype
    Zf = jnp.asarray(Z, dtype)
    op = build_mmw_operands(state, Zf)

    D_act = (Zf * rank_radio).astype(jnp.int32)       # active sketch columns
    col_mask = (jnp.arange(D_pad) < D_act)[None, :]   # [1, D_pad]

    if lanczos_m is None:
        lanczos_m = mmw_default_lanczos_m(eta, nit)

    mD = op.mask
    mF = op.asso_ut
    mH = op.mask

    carry0 = dict(
        e_accu_D=jnp.zeros((Kp,), dtype),
        e_accu_F=jnp.zeros((Kp, Kp), dtype),
        e_accu_H=jnp.zeros((Kp,), dtype),
        L_accu=jnp.zeros((Kp, Kp), dtype),
        X_mdiag=jnp.where(op.mask, 1.0, 0.0).astype(dtype),   # X0 = I (mmw.py:67)
        X_offdi=jnp.zeros((Kp, Kp), dtype),
        Y_D=jnp.zeros((Kp,), dtype),      # computed lazily below (uniform init)
        Y_F=jnp.zeros((Kp, Kp), dtype),
        Y_H=jnp.zeros((Kp,), dtype),
        X_avgd=jnp.zeros((Kp, Kp), dtype),
        Y_avgd_D=jnp.zeros((Kp,), dtype),
        Y_avgd_F=jnp.zeros((Kp, Kp), dtype),
        Y_avgd_H=jnp.zeros((Kp,), dtype),
        gap=jnp.zeros((nit if log_gap else 0, 2), dtype),
    )
    # Initial Y: uniform over the C valid constraints = softmax of zeros.
    y0D, y0F, y0H = _masked_softmax_3(
        jnp.zeros((Kp,), dtype), jnp.zeros((Kp, Kp), dtype), jnp.zeros((Kp,), dtype),
        mD, mF, mH)
    carry0.update(Y_D=y0D, Y_F=y0F, Y_H=y0H)

    def iteration(i, c):
        # ---- averaging (pre-update, mmw.py:77-78) -------------------------
        X_avgd = c["X_avgd"] + c["X_offdi"] + jnp.diag(c["X_mdiag"])
        YaD = c["Y_avgd_D"] + c["Y_D"]
        YaF = c["Y_avgd_F"] + c["Y_F"]
        YaH = c["Y_avgd_H"] + c["Y_H"]
        n_step = jnp.asarray(i + 1, dtype)

        gap = c["gap"]
        if log_gap:
            Xa = X_avgd / n_step
            eD_a, eF_a, eH_a = _violations(jnp.diagonal(Xa),
                                           Xa - jnp.diag(jnp.diagonal(Xa)),
                                           op, Zf, K)
            neg = jnp.asarray(-jnp.inf, dtype)
            ub = jnp.max(jnp.maximum(
                jnp.max(jnp.where(mD, eD_a, neg)),
                jnp.maximum(jnp.max(jnp.where(mF, eF_a, neg)),
                            jnp.max(jnp.where(mH, eH_a, neg)))))
            L_avg = _loss_matrix(YaD / n_step, YaF / n_step, YaH / n_step,
                                 op, Zf, K, Kp)
            gkey = jax.random.fold_in(key, 2 * nit + 7 + i)
            lam_min, _ = lanczos_extreme_eigs(
                lambda V: lax.dot(L_avg, V, precision=_PREC), gkey, Kp,
                m=gap_lanczos_m, dtype=dtype)
            lb = lam_min * K
            gap = lax.dynamic_update_index_in_dim(
                gap, jnp.stack([ub, lb]), i, axis=0)

        # ---- dual step (mmw.py:126-139) -----------------------------------
        eD, eF, eH = _violations(c["X_mdiag"], c["X_offdi"], op, Zf, K)
        e_accu_D = c["e_accu_D"] + eta * eD
        e_accu_F = c["e_accu_F"] + eta * jnp.where(mF, eF, 0.0)
        e_accu_H = c["e_accu_H"] + eta * eH
        YD, YF, YH = _masked_softmax_3(e_accu_D, e_accu_F, e_accu_H, mD, mF, mH)

        # ---- loss accumulation (mmw.py:146-167) ---------------------------
        L = _loss_matrix(YD, YF, YH, op, Zf, K, Kp)
        L_accu = c["L_accu"] - eta * L

        # ---- primal via sketched expm (mmw.py:172-194) --------------------
        gkey = jax.random.fold_in(key, i)
        G = jax.random.normal(gkey, (Kp, D_pad), dtype)
        G = jnp.where(col_mask & op.mask[:, None], G, 0.0)
        # Unit rows over the active columns (mmw.py:226-227).
        rn = jnp.linalg.norm(G, axis=1, keepdims=True)
        G = jnp.where(rn > 0, G / jnp.where(rn > 0, rn, 1.0), 0.0)

        X_half, _sigma = lanczos_expm_multiply(
            lambda V: 0.5 * lax.dot(L_accu, V, precision=_PREC), G,
            m=lanczos_m, small_method="taylor_ss", norm_bound=eta * nit)

        md = jnp.sum(X_half * X_half, axis=1)
        X_trace = jnp.sum(md) / K
        X_mdiag = jnp.where(op.mask, md / X_trace, 0.0)
        Gram = lax.dot(X_half, X_half.T, precision=_PREC) / X_trace
        X_offdi = jnp.where(op.xpat, Gram, 0.0)

        return dict(
            e_accu_D=e_accu_D, e_accu_F=e_accu_F, e_accu_H=e_accu_H,
            L_accu=L_accu, X_mdiag=X_mdiag, X_offdi=X_offdi,
            Y_D=YD, Y_F=YF, Y_H=YH,
            X_avgd=X_avgd, Y_avgd_D=YaD, Y_avgd_F=YaF, Y_avgd_H=YaH,
            gap=gap,
        )

    c = lax.fori_loop(0, nit, iteration, carry0)

    # ---- final averaged primal + factorization (mmw.py:202-222) -----------
    X_avgd = c["X_avgd"] / nit
    eD_a, eF_a, eH_a = _violations(jnp.diagonal(X_avgd),
                                   X_avgd - jnp.diag(jnp.diagonal(X_avgd)),
                                   op, Zf, K)
    neg = jnp.asarray(-jnp.inf, dtype)
    ub_final = jnp.max(jnp.maximum(
        jnp.max(jnp.where(mD, eD_a, neg)),
        jnp.maximum(jnp.max(jnp.where(mF, eF_a, neg)),
                    jnp.max(jnp.where(mH, eH_a, neg)))))

    rank_act = jnp.minimum(K - 1, ((Zf - 1.0) * rank_radio)).astype(jnp.int32)
    U, s = randomized_symmetric_lowrank(X_avgd, rank_pad,
                                        jax.random.fold_in(key, nit + 1))
    keep = (jnp.arange(rank_pad) < rank_act)[None, :]
    X_half = jnp.where(keep, U * jnp.sqrt(s)[None, :], 0.0)
    X_half = jnp.where(op.mask[:, None], X_half, 0.0)

    return MMWOutput(X_half=X_half, ub_final=ub_final, gap_log=c["gap"],
                     X_avgd=X_avgd)


def make_mmw_phase_fns(*, nit: int, eta: float, rank_radio: int, D_pad: int,
                       lanczos_m: Optional[int] = None):
    """Per-phase jitted step functions for profiled runs.

    Mirrors the reference's phase bracketing (``mmw.py:124-197``: "mmw_dual",
    "mmw_loss", "mmw_expm" timer keys) so ``sim_mmw_time``-style experiments
    measure the same phases on the device.  The fused :func:`mmw_solve` is the fast
    path; this one trades fusion for observability.
    """
    if lanczos_m is None:
        lanczos_m = mmw_default_lanczos_m(eta, nit)

    @functools.partial(jax.jit, static_argnames=("K",))
    def state_process(op: MMWOperands, Z, K: int):
        # Dummy touch so operand building is timed separately, like the
        # reference's "mmw_state_process" (mmw.py:70).
        return op

    @jax.jit
    def dual_step(op: MMWOperands, Z, X_mdiag, X_offdi, e_accu_D, e_accu_F,
                  e_accu_H):
        K = op.K
        Zf = jnp.asarray(Z, op.St.dtype)
        eD, eF, eH = _violations(X_mdiag, X_offdi, op, Zf, K)
        e_accu_D = e_accu_D + eta * eD
        e_accu_F = e_accu_F + eta * jnp.where(op.asso_ut, eF, 0.0)
        e_accu_H = e_accu_H + eta * eH
        YD, YF, YH = _masked_softmax_3(e_accu_D, e_accu_F, e_accu_H,
                                       op.mask, op.asso_ut, op.mask)
        return e_accu_D, e_accu_F, e_accu_H, YD, YF, YH

    @jax.jit
    def loss_step(op: MMWOperands, Z, L_accu, YD, YF, YH):
        K = op.K
        Zf = jnp.asarray(Z, op.St.dtype)
        L = _loss_matrix(YD, YF, YH, op, Zf, K, op.St.shape[-1])
        return L_accu - eta * L

    @jax.jit
    def expm_step(op: MMWOperands, Z, L_accu, key):
        K = op.K
        Kp = op.St.shape[-1]
        Zf = jnp.asarray(Z, op.St.dtype)
        D_act = (Zf * rank_radio).astype(jnp.int32)
        col_mask = (jnp.arange(D_pad) < D_act)[None, :]
        G = jax.random.normal(key, (Kp, D_pad), op.St.dtype)
        G = jnp.where(col_mask & op.mask[:, None], G, 0.0)
        rn = jnp.linalg.norm(G, axis=1, keepdims=True)
        G = jnp.where(rn > 0, G / jnp.where(rn > 0, rn, 1.0), 0.0)
        X_half, _ = lanczos_expm_multiply(
            lambda V: 0.5 * lax.dot(L_accu, V, precision=_PREC), G,
            m=lanczos_m, small_method="taylor_ss", norm_bound=eta * nit)
        md = jnp.sum(X_half * X_half, axis=1)
        X_trace = jnp.sum(md) / K
        X_mdiag = jnp.where(op.mask, md / X_trace, 0.0)
        Gram = lax.dot(X_half, X_half.T, precision=_PREC) / X_trace
        X_offdi = jnp.where(op.xpat, Gram, 0.0)
        return X_mdiag, X_offdi

    return state_process, dual_step, loss_step, expm_step


class MMW(StatsObject, SDPSolverBase):
    """Reference-compatible solver object (``mmw.py:12-24``) wrapping the
    jitted :func:`mmw_solve`.  One compilation per (Kp, nit, D_pad) bucket —
    Z varies without recompiling."""

    def __init__(self, nit: int = 100, rank_radio: int = 2, alpha: float = 1.0,
                 eta: float = 0.1, log_gap: bool = False,
                 lanczos_m: Optional[int] = None, seed: int = 0):
        SDPSolverBase.__init__(self, nit=nit, rank_radio=rank_radio, alpha=alpha)
        self.eta = eta
        self.LOG_GAP = log_gap
        self.lanczos_m = lanczos_m
        self._key = jax.random.PRNGKey(seed)
        self._ncall = 0
        self._jit_cache = {}

    def _solver_fn(self, Kp: int, K: int, D_pad: int, rank_pad: int, log_gap: bool):
        sig = (Kp, K, D_pad, rank_pad, log_gap, self.nit, self.eta,
               self.rank_radio, self.lanczos_m)
        if sig not in self._jit_cache:
            def fn(state, Z, key):
                return mmw_solve(state, Z, nit=self.nit, eta=self.eta,
                                 rank_radio=self.rank_radio, D_pad=D_pad,
                                 rank_pad=rank_pad, key=key,
                                 lanczos_m=self.lanczos_m, log_gap=log_gap)
            self._jit_cache[sig] = jax.jit(fn)
        return self._jit_cache[sig]

    def _d_pad_for(self, state: SigState, Z: int) -> Tuple[int, int]:
        # Pad sketch width to the binary-search upper bound so every probe
        # shares one executable; bucket to multiples of 16.
        _, ub = state.degree_bounds()
        zmax = max(int(Z), ub)
        D_pad = ((zmax * self.rank_radio + 15) // 16) * 16
        rank_pad = D_pad
        return D_pad, min(rank_pad, state.Kp - 1)

    def run_with_state(self, bs_iteration: int, Z: int, state: SigState,
                       D_pad: Optional[int] = None):
        tic = self._get_tic()
        if D_pad is None:
            D_pad, rank_pad = self._d_pad_for(state, Z)
        else:
            rank_pad = D_pad
        fn = self._solver_fn(state.Kp, state.K, D_pad, rank_pad, self.LOG_GAP)
        self._ncall += 1
        key = jax.random.fold_in(self._key, self._ncall)
        out = fn(state, float(Z), key)
        tim = self._get_tim(tic, sync=out.X_half)
        self._add_np_log("mmw_all_it", bs_iteration,
                         np.array([Z, state.K, tim]))
        if self.LOG_GAP:
            gap = np.asarray(out.gap_log)
            for i in range(gap.shape[0]):
                self._add_np_log("gap", i,
                                 np.array([gap[i, 0], gap[i, 1],
                                           gap[i, 0] - gap[i, 1]]))
        self.last_output = out
        return True, out.X_half

    def run_with_state_profiled(self, bs_iteration: int, Z: int,
                                state: SigState):
        """Profiled solve: per-phase wall timings under the reference's metric
        keys (mmw_state_process / mmw_dual / mmw_loss / mmw_expm / mmw_per_it
        / mmw_xavg; cf. ``sim_src/alg/mmw.py:70,142,170,197,200,221``).
        Numerically equivalent to :func:`mmw_solve` minus gap telemetry."""
        Kp, K = state.Kp, state.K
        D_pad, rank_pad = self._d_pad_for(state, Z)
        dtype = state.S.dtype
        sig = ("prof", D_pad, self.nit, self.eta, self.rank_radio,
               self.lanczos_m)
        if sig not in self._jit_cache:
            self._jit_cache[sig] = make_mmw_phase_fns(
                nit=self.nit, eta=self.eta, rank_radio=self.rank_radio,
                D_pad=D_pad, lanczos_m=self.lanczos_m)
        state_process, dual_step, loss_step, expm_step = self._jit_cache[sig]

        all_tic = self._get_tic()
        sp_tic = self._get_tic()
        op = jax.jit(build_mmw_operands)(state, jnp.asarray(float(Z), dtype))
        op = state_process(op, float(Z), K)
        tim = self._get_tim(sp_tic, sync=op.St)
        self._add_np_log("mmw_state_process", 0, np.array([Z, K, tim]))

        self._ncall += 1
        key = jax.random.fold_in(self._key, self._ncall)

        X_mdiag = jnp.where(state.mask, 1.0, 0.0).astype(dtype)
        X_offdi = jnp.zeros((Kp, Kp), dtype)
        eaD = jnp.zeros((Kp,), dtype)
        eaF = jnp.zeros((Kp, Kp), dtype)
        eaH = jnp.zeros((Kp,), dtype)
        L_accu = jnp.zeros((Kp, Kp), dtype)
        X_avgd = jnp.zeros((Kp, Kp), dtype)

        add_avg = jax.jit(lambda A, Xo, Xd: A + Xo + jnp.diag(Xd))

        for i in range(self.nit):
            per_tic = self._get_tic()
            X_avgd = add_avg(X_avgd, X_offdi, X_mdiag)

            tic = self._get_tic()
            eaD, eaF, eaH, YD, YF, YH = dual_step(op, float(Z), X_mdiag,
                                                  X_offdi, eaD, eaF, eaH)
            self._add_np_log("mmw_dual", i,
                             np.array([Z, K, self._get_tim(tic, sync=YH)]))

            tic = self._get_tic()
            L_accu = loss_step(op, float(Z), L_accu, YD, YF, YH)
            self._add_np_log("mmw_loss", i,
                             np.array([Z, K, self._get_tim(tic, sync=L_accu)]))

            tic = self._get_tic()
            X_mdiag, X_offdi = expm_step(op, float(Z),
                                         L_accu, jax.random.fold_in(key, i))
            self._add_np_log("mmw_expm", i,
                             np.array([Z, K, self._get_tim(tic, sync=X_offdi)]))

            self._add_np_log("mmw_per_it", i,
                             np.array([Z, K, self._get_tim(per_tic)]))

        tic = self._get_tic()
        X_avgd = X_avgd / self.nit
        rank_act = min(K - 1, (Z - 1) * self.rank_radio)
        U, s = jax.jit(randomized_symmetric_lowrank, static_argnames=("rank",))(
            X_avgd, rank_pad, jax.random.fold_in(key, self.nit + 1))
        keep = (jnp.arange(rank_pad) < rank_act)[None, :]
        X_half = jnp.where(keep, U * jnp.sqrt(s)[None, :], 0.0)
        X_half = jnp.where(state.mask[:, None], X_half, 0.0)
        self._add_np_log("mmw_xavg", 0,
                         np.array([Z, K, self._get_tim(tic, sync=X_half)]))
        self._add_np_log("mmw_all_it", bs_iteration,
                         np.array([Z, K, self._get_tim(all_tic)]))
        return True, X_half
