"""Sparse (ELL) randomized rounding + feasibility checker — the large-K path.

The dense rounding (:mod:`sig_sdp_mmw_tpu.models.rounding`) materializes
``S`` as ``[Kp, Kp]``; at the north-star scale (100k-1M links) that is tens
of GB.  This module re-derives the reference greedy rounding
(``sim_src/alg/sdp_solver.py:27-107``) on the static ELL state: the per-user
slot scan only ever touches the user's padded neighbor rows, so one greedy
step is O(Z_pad * deg) gathers and the whole attempt is O(K * Z_pad * deg).

Exact-trajectory argument (why S̃ = S-minus-assoc-minus-diag suffices even
though the reference checks against S-minus-diag, ``sdp_solver.py:30-34``):
the only S entries the two differ on are association pairs (i, j).  A user's
interference check reads ``gain_sum`` only at positions of *same-slot
assigned* S-neighbors and at itself; an association neighbor of any user k
can never be assigned to a slot k occupies (the association check at
``sdp_solver.py:87-92`` forbids it first), so an assoc-pair gain in
``gain_sum`` could only ever be read during a probe of a slot that the
association check rejects anyway — every slot accept/reject decision, and
hence the full greedy trajectory, is identical.  The independent checker
:func:`verify_assignment_ell` nevertheless accounts assoc-pair gains exactly
(via ``EllState.q_gain``) so its violation *counts* match the dense
:func:`sig_sdp_mmw_tpu.models.rounding.verify_assignment` bit-for-bit.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sig_sdp_mmw_tpu.core.ell import EllState


def _greedy_assign_ell(ell: EllState, order, pref, Z, Z_pad: int):
    """Greedy user-major assignment on the ELL state.

    Args:
      order: [Kp] user visit order (padded users last).
      pref:  [Z_pad, Kp] slot preference rank per user (0 = most preferred).
      Z: traced int32 — number of usable slots.

    Returns: (slot_of [Kp] int32 (-1 = unassigned), remainder, assigned mask).
    """
    Kp = ell.Kp
    dtype = ell.s_vals.dtype
    zs = jnp.arange(Z_pad, dtype=jnp.int32)
    slot_ok = zs < Z

    def user_step(kk, carry):
        slot_of, load = carry
        k = order[kk]
        valid_user = ell.mask[k]

        scols = ell.st_cols[k]                    # [degS] S row (no assoc/diag)
        svals = ell.st_vals[k]
        nbr_ok = svals != 0.0
        qcols = ell.q_cols[k]                     # [degQ] association neighbors
        qmask = ell.q_mask[k]

        nslot = slot_of[scols]                    # [degS] neighbor slots
        # Interference check at assigned same-slot S-neighbors
        # (sdp_solver.py:79-84): would adding k push neighbor j over budget?
        nload = load[:, scols]                    # [Z_pad, degS]
        vio_nbr = (nload + svals[None, :] > ell.h_max[scols][None, :])
        chk_nbr = nbr_ok[None, :] & (nslot[None, :] == zs[:, None])
        badH = jnp.any(chk_nbr & vio_nbr, axis=1)           # [Z_pad]
        # Self check: accumulated load at k's own AP (tmp_h[k] = 0 after
        # setdiag(0), so the self term is load alone).
        badSelf = load[:, k] > ell.h_max[k]                  # [Z_pad]
        # Association check (sdp_solver.py:87-92): no associated neighbor in
        # the candidate slot.
        qslot = slot_of[qcols]                    # [degQ]
        badA = jnp.any(qmask[None, :] & (qslot[None, :] == zs[:, None]), axis=1)

        feas = ~badH & ~badSelf & ~badA & slot_ok & valid_user
        cost = jnp.where(feas, pref[:, k], jnp.iinfo(jnp.int32).max)
        z_best = jnp.argmin(cost)
        got = feas[z_best]

        slot_of = slot_of.at[k].set(
            jnp.where(got, z_best.astype(jnp.int32), jnp.int32(-1)))
        # Accumulate k's interference row into the chosen slot's load
        # (padding slots carry svals == 0, so the scatter is mask-free).
        add = jnp.where(got, svals, jnp.zeros_like(svals)).astype(dtype)
        load = load.at[z_best, scols].add(add, mode="drop")
        return slot_of, load

    slot_of0 = jnp.full((Kp,), -1, jnp.int32)
    load0 = jnp.zeros((Z_pad, Kp), dtype)
    slot_of, _ = lax.fori_loop(0, ell.K, user_step, (slot_of0, load0))

    assigned = slot_of >= 0
    remainder = jnp.sum((~assigned) & ell.mask)
    return slot_of, remainder, assigned


def _greedy_assign_ell_wavefront(ell: EllState, order, pref, Z, Z_pad: int):
    """Parallel wavefront evaluation of the sequential greedy trajectory of
    :func:`_greedy_assign_ell` — the large-K rounding path (the sequential
    scan is K dependent steps, one per user).

    The sequential scan's decision for user k reads only the assignments of
    k's earlier-ordered graph neighbors (S̃ row + S̃ column + Q row) and the
    interference loads at those neighbors.  Each round decides, in one
    vectorized step, every user whose earlier-ordered neighbors are all
    decided.  No two ready users are 1-hop neighbors, so the association
    checks and direct reads are conflict-free; the one intra-round hazard
    is SECOND-ORDER: two same-round committers sharing an S̃ neighbor j can
    jointly overflow j's budget even though each passed its check alone.
    The round therefore ends with a repair pass: at every violated (j,
    slot), the minimum-rank participant keeps its slot and every other
    same-round contributor returns to UNDECIDED (retried next round with
    fresh loads).  The global minimum-rank undecided user can never be
    rolled back, so every round decides at least one user and the loop
    terminates.

    The result is bit-identical to the sequential scan whenever no repair
    triggers, and otherwise differs only in how rank ties at shared
    neighbors are serialized — every accepted user still passed the exact
    reference checks (``sdp_solver.py:79-92``) against the loads at its
    decision round, so ``remainder == 0`` still implies a feasible
    assignment (the feasibility invariant the checker verifies
    independently; pinned by ``tests/test_rounding_ell.py``).
    """
    rank = jnp.zeros((ell.Kp,), jnp.int32).at[order].set(
        jnp.arange(ell.Kp, dtype=jnp.int32))

    def cond(state):
        _, _, decided = state
        return ~jnp.all(decided)

    slot_of, _, _ = lax.while_loop(
        cond, lambda s: _wavefront_round(ell, rank, pref.T, Z, Z_pad, s),
        _wavefront_state0(ell, Z_pad))
    assigned = slot_of >= 0
    remainder = jnp.sum((~assigned) & ell.mask)
    return slot_of, remainder, assigned


def _wavefront_state0(ell: EllState, Z_pad: int):
    return (jnp.full((ell.Kp,), -1, jnp.int32),
            jnp.zeros((ell.Kp, Z_pad), ell.s_vals.dtype),
            ~ell.mask)


def _wavefront_round(ell: EllState, rank, prefT, Z, Z_pad: int, state):
    """One wavefront round (see :func:`_greedy_assign_ell_wavefront`).
    A no-op once every user is decided, so running extra rounds is safe —
    the segmented host driver exploits this to run fixed-size chunks.

    SCATTER-FREE formulation: every per-edge accumulation is expressed on
    the receiving side through the transpose edge view (``ell.s_*`` is the
    transpose of ``ell.st_*`` with matching values), as a gather +
    broadcast-compare + row reduce over [Kp, deg, Z_pad] — XLA fuses these
    into data-parallel loops, whereas the equivalent scatter-adds/maxes
    serialize on colliding indices."""
    Kp = ell.Kp
    INT_MAX = jnp.iinfo(jnp.int32).max
    zs = jnp.arange(Z_pad, dtype=jnp.int32)
    slot_ok = (zs < Z)[None, :]                     # [1, Z_pad]

    scols, svals = ell.st_cols, ell.st_vals         # out-edges: S row of k
    nbr_ok = svals != 0.0
    qcols, qmask = ell.q_cols, ell.q_mask
    ccols, cvals = ell.s_cols, ell.s_vals           # in-edges of j (transpose)
    cin_ok = cvals != 0.0
    h_nbr = ell.h_max[scols]

    def undecided_earlier(cols, ok, decided):
        return jnp.any(ok & (rank[cols] < rank[:, None]) & ~decided[cols],
                       axis=1)

    slot_of, loadT, decided = state
    ready = ~decided & ~(
        undecided_earlier(scols, nbr_ok, decided)
        | undecided_earlier(ccols, cin_ok, decided)
        | undecided_earlier(qcols, qmask, decided))

    # Interference check (sdp_solver.py:79-84): neighbor j (decided, slot
    # z_j) vetoes slot z_j for k iff load[j, z_j] + S_kj > h_j.
    zj = slot_of[scols]                          # [Kp, degS]
    dj = nbr_ok & (zj >= 0)
    over = loadT[scols, jnp.maximum(zj, 0)] + svals > h_nbr
    badH = jnp.any((dj & over)[:, :, None] & (zj[:, :, None] == zs), axis=1)
    badSelf = loadT > ell.h_max[:, None]          # [Kp, Z_pad]
    zq = slot_of[qcols]
    dq = qmask & (zq >= 0)
    badA = jnp.any(dq[:, :, None] & (zq[:, :, None] == zs), axis=1)

    feas = ~badH & ~badSelf & ~badA & slot_ok & ell.mask[:, None]
    cost = jnp.where(feas, prefT, INT_MAX)
    z_best = jnp.argmin(cost, axis=1).astype(jnp.int32)
    got = jnp.take_along_axis(feas, z_best[:, None], axis=1)[:, 0]
    commit = ready & got

    # ---- intra-round repair (see docstring) ------------------------------
    # Tentative load delta at j, per slot: sum of committed in-neighbors'
    # gains landing in that slot (in-edge view; no scatter).
    cin = ccols
    commit_in = commit[cin] & cin_ok              # [Kp, degS]
    zin = z_best[cin]
    delta = jnp.sum(jnp.where(commit_in[:, :, None]
                              & (zin[:, :, None] == zs),
                              cvals[:, :, None], 0.0), axis=1)
    tentT = loadT + delta
    slot_tent = jnp.where(commit, z_best, slot_of)
    viol_u = (slot_tent >= 0) & (jnp.take_along_axis(
        tentT, jnp.maximum(slot_tent, 0)[:, None], axis=1)[:, 0]
        > ell.h_max)
    # Minimum participant rank per violated j: in-edge contributors plus
    # the assignee itself when committed this round.
    contrib_in = commit_in & (zin == slot_tent[:, None]) & (slot_tent >= 0)[:, None]
    minrank = jnp.min(jnp.where(contrib_in, rank[cin], INT_MAX), axis=1)
    minrank = jnp.minimum(minrank, jnp.where(commit, rank, INT_MAX))
    # Rollback per out-edge: k contributed to a violated j and is not the
    # minimum-rank participant there.
    zk = jnp.broadcast_to(z_best[:, None], scols.shape)
    contrib_out = (commit[:, None] & nbr_ok
                   & (zk == slot_tent[scols]) & (slot_tent[scols] >= 0))
    rank_b = jnp.broadcast_to(rank[:, None], scols.shape)
    roll_edge = contrib_out & viol_u[scols] & (rank_b > minrank[scols])
    rollback = (jnp.any(roll_edge, axis=1)
                | (commit & viol_u & (rank > minrank)))
    keep = commit & ~rollback

    keep_in = keep[cin] & cin_ok
    delta2 = jnp.sum(jnp.where(keep_in[:, :, None]
                               & (zin[:, :, None] == zs),
                               cvals[:, :, None], 0.0), axis=1)
    loadT = loadT + delta2
    slot_of = jnp.where(keep, z_best,
                        jnp.where(ready & ~got, -1, slot_of))
    # Rolled-back users stay undecided and retry next round.
    return slot_of, loadT, decided | (ready & ~got) | keep


@functools.partial(jax.jit, static_argnames=("Z_pad", "rounds"))
def _wavefront_exec(ell: EllState, rank, prefT, Z, state, Z_pad: int,
                    rounds: int):
    """``rounds`` wavefront rounds as ONE device execution (extra rounds
    after convergence are no-ops) — the segmented building block for
    runtimes that bound a single execution's work."""
    return lax.fori_loop(
        0, rounds,
        lambda _, s: _wavefront_round(ell, rank, prefT, Z, Z_pad, s), state)


@functools.partial(jax.jit, static_argnames=("Z_pad",))
def _wavefront_prep(ell: EllState, gX, Z, key, Z_pad: int):
    """Ordering + slot preferences + initial state for one attempt
    (the reference recipe, ``sdp_solver.py:48-57``)."""
    rv = jax.random.normal(key, (Z_pad, gX.shape[1]), ell.s_vals.dtype)
    active = jnp.any(gX != 0.0, axis=0)[None, :]
    rv = jnp.where(active, rv, 0.0)
    rn = jnp.linalg.norm(rv, axis=1, keepdims=True)
    rv = jnp.where(rn > 0, rv / jnp.where(rn > 0, rn, 1.0), 0.0)
    norms = jnp.linalg.norm(gX, axis=1)
    order = jnp.argsort(-jnp.where(ell.mask, norms, -jnp.inf))
    rank = jnp.zeros((ell.Kp,), jnp.int32).at[order].set(
        jnp.arange(ell.Kp, dtype=jnp.int32))
    inprod = rv @ gX.T
    slot_ok = (jnp.arange(Z_pad) < Z)[:, None]
    pref = jnp.argsort(jnp.argsort(-jnp.where(slot_ok, inprod, -jnp.inf),
                                   axis=0), axis=0)
    return rank, pref.T, _wavefront_state0(ell, Z_pad)


def _rounding_wavefront_host(ell: EllState, gX, Z, key, Z_pad: int,
                             nattempt: int, rounds_per_exec: int = 16
                             ) -> Tuple[np.ndarray, int]:
    """Host-segmented wavefront rounding: chunked short device executions
    with a convergence check (scalar pull) between chunks — the large-K
    driver, which keeps every device execution short."""
    Zt = jnp.int32(Z)
    best = None
    for a in range(nattempt):
        akey = jax.random.fold_in(key, a)
        rank, prefT, state = _wavefront_prep(ell, gX, Zt, akey, Z_pad)
        while True:
            state = _wavefront_exec(ell, rank, prefT, Zt, state, Z_pad,
                                    rounds_per_exec)
            if bool(jnp.all(state[2])):
                break
        slot_of = state[0]
        rem = int(jnp.sum((slot_of < 0) & ell.mask))
        if best is None or rem < best[1]:
            fkey = jax.random.fold_in(akey, 99)
            fill = jax.random.randint(fkey, (ell.Kp,), 0,
                                      max(int(Z), 1), jnp.int32)
            z_vec = jnp.where(slot_of >= 0, slot_of, fill)
            z_vec = jnp.where(ell.mask, z_vec, 0)
            best = (np.asarray(z_vec), rem)
        if rem == 0:
            break
    return best


def _one_attempt_ell(ell: EllState, gX, randv, Z, Z_pad: int,
                     wavefront: bool = False):
    """One rounding attempt: the reference's ordering + preference recipe
    (``sdp_solver.py:48-57``) on the ELL state."""
    norms = jnp.linalg.norm(gX, axis=1)
    order = jnp.argsort(-jnp.where(ell.mask, norms, -jnp.inf))
    inprod = randv @ gX.T                         # [Z_pad, Kp]
    slot_ok = (jnp.arange(Z_pad) < Z)[:, None]
    pref = jnp.argsort(jnp.argsort(-jnp.where(slot_ok, inprod, -jnp.inf),
                                   axis=0), axis=0)
    assign = (_greedy_assign_ell_wavefront if wavefront
              else _greedy_assign_ell)
    return assign(ell, order, pref, Z, Z_pad)


@functools.partial(jax.jit, static_argnames=("Z_pad", "nattempt"))
def _rounding_batch_ell(ell: EllState, gX, Z, key, Z_pad: int, nattempt: int):
    Kp = ell.Kp
    D = gX.shape[1]

    def attempt(akey):
        rv = jax.random.normal(akey, (Z_pad, D), ell.s_vals.dtype)
        active = jnp.any(gX != 0.0, axis=0)[None, :]
        rv = jnp.where(active, rv, 0.0)
        rn = jnp.linalg.norm(rv, axis=1, keepdims=True)
        rv = jnp.where(rn > 0, rv / jnp.where(rn > 0, rn, 1.0), 0.0)
        return _one_attempt_ell(ell, gX, rv, Z, Z_pad)

    keys = jax.random.split(key, nattempt)
    slots, rems, assigned = jax.vmap(attempt)(keys)

    ok = rems == 0
    first_ok = jnp.argmax(ok)
    pick = jnp.where(jnp.any(ok), first_ok, nattempt - 1)
    slot_of = slots[pick]
    rem = rems[pick]
    asn = assigned[pick]

    # Random fallback for unassigned users (sdp_solver.py:104-105).
    fkey = jax.random.fold_in(key, 99)
    fill = jax.random.randint(fkey, (Kp,), 0, jnp.maximum(Z, 1), jnp.int32)
    z_vec = jnp.where(asn, slot_of, fill)
    z_vec = jnp.where(ell.mask, z_vec, 0)
    return z_vec, rem


def default_z_pad_ell(ell: EllState, Z: int = None) -> int:
    """Static slot-axis padding.  With ``Z`` given, bucket to the smallest
    power of two >= max(Z, 16): every [Z_pad, Kp] rounding buffer (and the
    per-user slot scan) then scales with the probe's own Z instead of the
    search window's upper bound — at K~100k with ub~108 the late (small-Z)
    probes shrink ~4x.  Power-of-two bucketing keeps the executable count
    logarithmic over a binary search; slots >= Z are masked (`slot_ok`), so
    a smaller Z inside a wider pad remains a VALID randomized attempt.
    (Note the trajectory is not bit-identical across pads: threefry derives
    each element's bits from the full draw shape, so ``normal(key, (Z_pad,
    D))`` yields different vectors per Z_pad bucket — masking guarantees
    correctness, not cross-bucket reproducibility.)"""
    if Z is not None:
        return 1 << (max(int(Z), 16) - 1).bit_length()
    _, ub = ell.degree_bounds()
    return ((ub + 15) // 16) * 16


@functools.partial(jax.jit, static_argnames=("Z_pad", "wavefront"))
def _rounding_single_ell(ell: EllState, gX, Z, key, Z_pad: int,
                         wavefront: bool = False):
    """One attempt + random fallback — the sequential-retry building block."""
    rv = jax.random.normal(key, (Z_pad, gX.shape[1]), ell.s_vals.dtype)
    active = jnp.any(gX != 0.0, axis=0)[None, :]
    rv = jnp.where(active, rv, 0.0)
    rn = jnp.linalg.norm(rv, axis=1, keepdims=True)
    rv = jnp.where(rn > 0, rv / jnp.where(rn > 0, rn, 1.0), 0.0)
    slot_of, rem, asn = _one_attempt_ell(ell, gX, rv, Z, Z_pad,
                                         wavefront=wavefront)
    fkey = jax.random.fold_in(key, 99)
    fill = jax.random.randint(fkey, (ell.Kp,), 0, jnp.maximum(Z, 1), jnp.int32)
    z_vec = jnp.where(asn, slot_of, fill)
    z_vec = jnp.where(ell.mask, z_vec, 0)
    return z_vec, rem


# Row-count cap for batching all attempts into one vmapped device program.
# Batching trades the reference's first-success early exit
# (sdp_solver.py:18-25) for one device program whose sequential user scan is
# shared by all attempts — a clear win at small K.  At large K the
# batched program's work grows as rows x attempts while the sequential
# loop's first-success early exit usually stops after one attempt
# (feasible probes succeed on attempt 1), so above the cap attempts run
# one at a time.  The default of 16384 rows was set on an earlier
# accelerator and has not been re-derived on the GPU;
# SIG_SDP_BATCH_ROUNDING_MAX_KP overrides it.
_BATCH_ATTEMPT_MAX_KP = int(os.environ.get("SIG_SDP_BATCH_ROUNDING_MAX_KP",
                                           16384))

# Above this row count the sequential-retry path evaluates the greedy
# trajectory via the parallel wavefront (identical result, rounds instead
# of K sequential steps).
_WAVEFRONT_MIN_KP = int(os.environ.get("SIG_SDP_WAVEFRONT_MIN_KP", 16384))


def rounding_ell(Z: int, gX, ell: EllState, key, nattempt: int = 10,
                 Z_pad: int = None, batch_attempts: bool = None
                 ) -> Tuple[np.ndarray, int, int]:
    """Reference-compatible entry (``sdp_solver.py:18``) on the ELL state.

    ``batch_attempts``: run all ``nattempt`` attempts as one vmapped device
    program (one shared user scan) vs. a host retry loop with first-success
    exit (the reference's own control flow; the memory-lean 1M-link default).
    """
    if Z_pad is None:
        Z_pad = default_z_pad_ell(ell, Z)
    if batch_attempts is None:
        batch_attempts = ell.Kp <= _BATCH_ATTEMPT_MAX_KP
    gX = jnp.asarray(gX)
    if batch_attempts:
        z_vec, rem = _rounding_batch_ell(ell, gX, jnp.int32(Z), key,
                                         Z_pad=Z_pad, nattempt=nattempt)
        return np.asarray(z_vec)[: ell.K], Z, int(rem)

    if ell.Kp > _WAVEFRONT_MIN_KP:
        # Large K: the parallel-wavefront evaluation of the same greedy
        # trajectory (see _greedy_assign_ell_wavefront) in segmented device
        # executions — the K-step sequential scan costs minutes at 1M links.
        z_vec, rem = _rounding_wavefront_host(ell, gX, Z, key, Z_pad,
                                              nattempt)
        return np.asarray(z_vec)[: ell.K], Z, rem

    for a in range(nattempt):
        akey = jax.random.fold_in(key, a)
        z_vec, rem = _rounding_single_ell(ell, gX, jnp.int32(Z), akey,
                                          Z_pad=Z_pad)
        rem = int(rem)
        if rem == 0:
            break
    return np.asarray(z_vec)[: ell.K], Z, rem


def rounding_native_csr(Z: int, gX, S_csr, Q_csr, h_max, key,
                        nattempt: int = 10,
                        StT_csr=None) -> Tuple[np.ndarray, int, int]:
    """Reference rounding (``sdp_solver.py:18-107``) with the greedy scan in
    the native C++ loop — the production large-K path: the scan is
    sequential and pointer-chasing, which no on-device formulation runs
    well (see csrc/sig_native.cpp::sig_greedy_round).

    Consumes the host CSR state directly (no EllState needed).  Ordering
    and slot preferences follow the reference recipe exactly: users by
    decreasing ||gX row|| (``:51``), slots by decreasing inner product with
    per-attempt random unit vectors (``:48-57``); unassigned users get the
    random fallback (``:104-105``).  Returns (z_vec, Z, remainder).
    """
    from sig_sdp_mmw_tpu.core.ell import build_st_csr
    from sig_sdp_mmw_tpu.native import greedy_round_native

    K = S_csr.shape[0]
    StT = (StT_csr if StT_csr is not None
           else build_st_csr(S_csr, Q_csr).transpose().tocsr())
    h = np.asarray(h_max, np.float64)

    gX = jnp.asarray(gX)
    D = gX.shape[1]
    norms = np.asarray(jnp.linalg.norm(gX, axis=1))[:K]
    user_order = np.argsort(-norms, kind="stable").astype(np.int64)

    best = None
    for a in range(nattempt):
        akey = jax.random.fold_in(key, a)
        rv = jax.random.normal(akey, (Z, D), gX.dtype)
        rn = jnp.linalg.norm(rv, axis=1, keepdims=True)
        rv = jnp.where(rn > 0, rv / jnp.where(rn > 0, rn, 1.0), 0.0)
        inprod = np.asarray(rv @ gX.T)[:, :K]            # [Z, K]
        slot_order = np.argsort(-inprod, axis=0,
                                kind="stable").T.astype(np.int32)
        slot_order = np.ascontiguousarray(slot_order)    # [K, Z]
        slot_of, rem = greedy_round_native(StT, Q_csr.tocsr(), h,
                                           user_order, slot_order, int(Z))
        if best is None or rem < best[1]:
            best = (slot_of, rem, akey)
        if rem == 0:
            break

    slot_of, rem, akey = best
    if rem:
        fkey = jax.random.fold_in(akey, 99)
        fill = np.asarray(jax.random.randint(fkey, (K,), 0, max(int(Z), 1),
                                             jnp.int32))
        slot_of = np.where(slot_of >= 0, slot_of, fill).astype(np.int32)
    return slot_of, Z, rem


def verify_assignment_csr(S_csr, Q_csr, h_max, z_vec) -> Tuple[bool, int, int]:
    """Independent O(nnz) feasibility checker on the host CSR state.

    Same semantics as :func:`verify_assignment_ell` /
    :func:`sig_sdp_mmw_tpu.models.rounding.verify_assignment` (interference
    load at user j = sum of same-slot S[k, j] over k != j vs ``h_max[j]``;
    association violation = same-slot associated pair), but consuming the
    scipy matrices directly — no device arrays touched, so it checks the
    schedule independently of the state the solver ran on.
    """
    S = S_csr.tocoo()
    z = np.asarray(z_vec).astype(np.int64)
    K = S.shape[0]
    h = np.asarray(h_max, np.float64)

    offd = S.row != S.col
    same = offd & (z[S.row] == z[S.col])
    load = np.zeros(K, np.float64)
    np.add.at(load, S.col[same], S.data[same].astype(np.float64))
    n_interf = int(np.sum(load > h))

    # Count association violations on the upper triangle of the symmetrized
    # pattern, so a Q that stores only one triangle still counts each
    # violated pair exactly once.
    Qc = Q_csr.tocoo()
    qoff = (Qc.row != Qc.col) & (Qc.data != 0)
    lo = np.minimum(Qc.row[qoff], Qc.col[qoff]).astype(np.int64)
    hi = np.maximum(Qc.row[qoff], Qc.col[qoff]).astype(np.int64)
    pairs = np.unique(lo * K + hi)
    n_asso = int(np.sum(z[pairs // K] == z[pairs % K]))
    return (n_interf == 0 and n_asso == 0), n_interf, n_asso


def verify_assignment_ell(ell: EllState, z_vec) -> Tuple[bool, int, int]:
    """Independent O(nnz) feasibility checker on the ELL state (host numpy).

    Semantics identical to the dense
    :func:`sig_sdp_mmw_tpu.models.rounding.verify_assignment`: interference
    load at user j = sum of same-slot S[k, j] over k != j (S̃ rows plus the
    assoc-pair gains from ``q_gain``), compared against ``h_max``; an
    association violation is a same-slot associated pair.
    """
    K = ell.K
    Kp = ell.Kp
    z = np.full(Kp, -1, np.int64)
    z[:K] = np.asarray(z_vec)[:K]
    mask = np.asarray(ell.mask)
    h = np.asarray(ell.h_max, np.float64)

    load = np.zeros(Kp, np.float64)
    # S̃ rows: st row k holds S[k, j] for non-assoc, non-diag neighbors j.
    st_cols = np.asarray(ell.st_cols)
    st_vals = np.asarray(ell.st_vals, np.float64)
    rows = np.repeat(np.arange(Kp), st_cols.shape[1]).reshape(st_cols.shape)
    same = (z[rows] == z[st_cols]) & (st_vals != 0) & mask[rows]
    np.add.at(load, st_cols[same], st_vals[same])
    # Assoc-pair gains (stripped from S̃ but present in the reference's S).
    q_cols = np.asarray(ell.q_cols)
    q_gain = np.asarray(ell.q_gain, np.float64)
    q_mask = np.asarray(ell.q_mask)
    rowsq = np.repeat(np.arange(Kp), q_cols.shape[1]).reshape(q_cols.shape)
    sameq = (z[rowsq] == z[q_cols]) & q_mask & mask[rowsq]
    np.add.at(load, q_cols[sameq], q_gain[sameq])

    n_interf = int(np.sum((load > h) & mask))

    a_i = np.asarray(ell.a_i)
    a_j = np.asarray(ell.a_j)
    a_mask = np.asarray(ell.a_mask)
    n_asso = int(np.sum(a_mask & (z[a_i] == z[a_j])))
    return (n_interf == 0 and n_asso == 0), n_interf, n_asso
