"""Randomized rounding: SDP factor -> feasible slot assignment, plus an
independent feasibility checker.

Faithful semantics of the reference greedy rounding
(``sim_src/alg/sdp_solver.py:18-107``), re-shaped for compiled execution:

* one attempt is a jitted ``lax.fori_loop`` over users (in decreasing
  ``||gX_k||`` order); the per-user slot scan — the reference's nested
  ``for zz in range(Z)`` with sparse-row ops — becomes a single masked
  [Z_pad, Kp] feasibility evaluation over ALL candidate slots at once,
  followed by "first feasible in preference order" selection;
* the reference's up-to-10 serial retries (``sdp_solver.py:18-25``) are a
  ``vmap`` over attempt keys — attempt-parallelism is semantically faithful
  (independent randomness) and batches on the device;
* ``Z`` is traced; ``Z_pad`` (slot-axis padding) is static so one executable
  serves the whole binary search.

:func:`verify_assignment` is the independent invariant checker (SURVEY §4.2):
``remainder == 0`` from rounding must imply it passes.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sig_sdp_mmw_tpu.core.problem import SigState


def _greedy_assign(state: SigState, order, pref, Z, Z_pad: int):
    """Greedy user-major assignment core shared by SDP rounding, LP rounding
    and the MAX_RAND heuristic (all three use the same feasibility scans,
    only the user order and slot preference differ).

    Args:
      state: problem state (S diag is removed internally, as in the reference).
      order: [Kp] user visit order (padded users last).
      pref: [Z_pad, Kp] slot preference rank per user (0 = most preferred).
      Z: traced int — number of usable slots.

    Returns: (z_vec [Kp] int32, remainder scalar int32, assigned mask).
    """
    Kp = state.Kp
    dtype = state.S.dtype
    eye = jnp.eye(Kp, dtype=bool)
    S = jnp.where(eye, 0.0, state.S)            # setdiag(0) (sdp_solver.py:33)
    Q = state.Q
    h_max = state.h_max
    mask = state.mask
    Snz = S != 0.0
    slot_ok = (jnp.arange(Z_pad) < Z)[:, None]

    def user_step(kk, carry):
        slot_of, gain_sum, asso_sum = carry
        k = order[kk]
        valid_user = mask[k]

        s_row = S[k]                             # [Kp] user k's gains
        q_row = Q[k]
        self_hot = eye[k]

        # Feasibility of every candidate slot simultaneously.
        slot_eq = slot_of[None, :] == jnp.arange(Z_pad)[:, None]   # [Z_pad, Kp]
        # Interference check positions: same-slot assigned S-neighbors + self
        # (sdp_solver.py:79-84).
        chkH = (slot_eq & Snz[k][None, :]) | self_hot[None, :]
        vioH = gain_sum + s_row[None, :] > h_max[None, :]
        okH = ~jnp.any(chkH & vioH, axis=1)                        # [Z_pad]
        # Association check (sdp_solver.py:87-92).
        chkA = (slot_eq & (q_row != 0)[None, :]) | self_hot[None, :]
        vioA = asso_sum + q_row[None, :] >= 1.0
        okA = ~jnp.any(chkA & vioA, axis=1)

        feas = okH & okA & slot_ok[:, 0] & valid_user
        # First feasible slot in preference order.
        cost = jnp.where(feas, pref[:, k], jnp.iinfo(jnp.int32).max)
        z_best = jnp.argmin(cost)
        got = feas[z_best]

        zhot = (jnp.arange(Z_pad) == z_best)[:, None] & got
        gain_sum = gain_sum + jnp.where(zhot, s_row[None, :], 0.0)
        asso_sum = asso_sum + jnp.where(zhot, q_row[None, :], 0.0)
        slot_of = slot_of.at[k].set(jnp.where(got, z_best.astype(jnp.int32),
                                              jnp.int32(-1)))
        return slot_of, gain_sum, asso_sum

    slot_of0 = jnp.full((Kp,), -1, jnp.int32)
    gain0 = jnp.zeros((Z_pad, Kp), dtype)
    asso0 = jnp.zeros((Z_pad, Kp), dtype)
    slot_of, _, _ = lax.fori_loop(0, state.K, user_step,
                                  (slot_of0, gain0, asso0))

    assigned = slot_of >= 0
    remainder = jnp.sum((~assigned) & mask)
    return slot_of, remainder, assigned


def _one_attempt(state: SigState, gX, randv, Z, Z_pad: int):
    """One SDP rounding attempt (``sdp_solver.py:27-107``)."""
    # User order: decreasing ||gX row|| (sdp_solver.py:51); padded users last.
    norms = jnp.linalg.norm(gX, axis=1)
    order = jnp.argsort(-jnp.where(state.mask, norms, -jnp.inf))

    # Slot preference: decreasing inner product (sdp_solver.py:56-57).
    inprod = randv @ gX.T                        # [Z_pad, Kp]
    slot_ok = (jnp.arange(Z_pad) < Z)[:, None]
    pref = jnp.argsort(jnp.argsort(-jnp.where(slot_ok, inprod, -jnp.inf),
                                   axis=0), axis=0)
    return _greedy_assign(state, order, pref, Z, Z_pad)


@functools.partial(jax.jit, static_argnames=("Z_pad", "nattempt"))
def _rounding_batch(state: SigState, gX, Z, key, Z_pad: int, nattempt: int):
    Kp = state.Kp
    D = gX.shape[1]

    def attempt(akey):
        rv = jax.random.normal(akey, (Z_pad, D), state.S.dtype)
        # Zero inactive factor dims so unit-norm is over the active subspace.
        active = jnp.any(gX != 0.0, axis=0)[None, :]
        rv = jnp.where(active, rv, 0.0)
        rn = jnp.linalg.norm(rv, axis=1, keepdims=True)
        rv = jnp.where(rn > 0, rv / jnp.where(rn > 0, rn, 1.0), 0.0)
        return _one_attempt(state, gX, rv, Z, Z_pad)

    keys = jax.random.split(key, nattempt)
    slots, rems, assigned = jax.vmap(attempt)(keys)

    # First attempt with remainder 0, else the last attempt (sdp_solver.py:18-25).
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
    z_vec = jnp.where(state.mask, z_vec, 0)
    return z_vec, rem


def rounding(Z: int, gX, state: SigState, key, nattempt: int = 10,
             Z_pad: int = None) -> Tuple[np.ndarray, int, int]:
    """Reference-compatible entry (``sdp_solver.py:18``): returns
    (z_vec, Z, remainder) with z_vec as a host ndarray of length K."""
    if Z_pad is None:
        Z_pad = _default_z_pad(state)
    z_vec, rem = _rounding_batch(state, jnp.asarray(gX), jnp.int32(Z), key,
                                 Z_pad=Z_pad, nattempt=nattempt)
    return np.asarray(z_vec)[: state.K], Z, int(rem)


def _default_z_pad(state: SigState) -> int:
    _, ub = state.degree_bounds()
    return ((ub + 15) // 16) * 16


# ---------------------------------------------------------------------------
# Independent feasibility checker (the test oracle; SURVEY §4.2)
# ---------------------------------------------------------------------------

def verify_assignment(state: SigState, z_vec) -> Tuple[bool, int, int]:
    """Check the two scheduling constraints directly on an assignment.

    * interference: for every user j, the summed same-slot gain load at j's AP
      must not exceed ``h_max[j]`` (the accumulating check of
      ``sdp_solver.py:79-84`` at convergence);
    * association: no two associated users share a slot
      (``sdp_solver.py:87-92`` — at most one user per AP per slot).

    Returns (ok, n_interference_violations, n_association_violations).
    """
    K = state.K
    S = np.asarray(state.S, dtype=np.float64)[:K, :K].copy()
    Q = np.asarray(state.Q, dtype=np.float64)[:K, :K]
    h = np.asarray(state.h_max, dtype=np.float64)[:K]
    np.fill_diagonal(S, 0.0)
    z = np.asarray(z_vec)[:K]

    same = z[None, :] == z[:, None]
    np.fill_diagonal(same, False)
    load = (S * same).sum(axis=0)           # column j: sum of same-slot rows
    n_interf = int(np.sum(load > h))
    n_asso = int(np.sum((Q != 0) & same) // 2)
    return (n_interf == 0 and n_asso == 0), n_interf, n_asso


def rounding_one_attempt(Z: int, gX, state: SigState, key, Z_pad: int = None):
    """Single-attempt variant (reference ``rounding_one_attempt``)."""
    if Z_pad is None:
        Z_pad = _default_z_pad(state)
    z_vec, rem = _rounding_batch(state, jnp.asarray(gX), jnp.int32(Z), key,
                                 Z_pad=Z_pad, nattempt=1)
    return np.asarray(z_vec)[: state.K], Z, int(rem)
