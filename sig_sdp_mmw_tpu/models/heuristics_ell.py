"""Greedy scheduling heuristics on the sparse ELL state — large-K baselines.

The dense heuristics (:mod:`sig_sdp_mmw_tpu.models.heuristics`) materialize
``[Kp, Kp]`` matrices and stop scaling near K~10k; these re-derive the same
reference semantics (``sim_src/alg/gm.py:8-200``) on :class:`EllState`, so
the 100k+-link pipeline has heuristic comparison points.

Equivalence note (slot-major reference -> user-major implementation): the
reference packs slot-by-slot, scanning users in score order within each slot
(``gm.py:24-58``).  With a deterministic global score order and
lowest-slot-first preference, user-major greedy (each user takes the lowest
feasible slot given all higher-ranked users' assignments) reaches the
identical assignment: by induction over the score order, a user's lowest
feasible slot depends only on where the higher-ranked users landed, which
both schedules determine identically.  The feasibility scan itself is the
O(deg * Z_pad) gather loop the ELL rounding already implements
(:func:`sig_sdp_mmw_tpu.models.rounding_ell._greedy_assign_ell`); the
S-tilde-vs-S trajectory-equivalence argument from that module applies to the
heuristics too (an association neighbor can never be a same-slot member, so
the stripped assoc-pair gains never influence an accept/reject decision —
``gm.py:37-47`` runs both checks before accepting).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sig_sdp_mmw_tpu.core.ell import EllState
from sig_sdp_mmw_tpu.models.rounding_ell import (
    _greedy_assign_ell, default_z_pad_ell)
from sig_sdp_mmw_tpu.utils.stats import StatsObject


@jax.jit
def incoming_gain_scores(ell: EllState) -> jnp.ndarray:
    """MAX_GAIN rank: total incoming interference per user — row sums of
    S^T with zero diagonal (``gm.py:18``).  The ELL state strips assoc-pair
    gains from S-tilde, so they are added back from ``q_gain``.

    Jitted: one compiled call instead of a chain of eager ops (each of
    which dispatches, and at first use compiles, on its own)."""
    # s_vals row k holds S[j, k] for non-assoc in-neighbors j.
    base = jnp.sum(ell.s_vals, axis=1)
    # Incoming assoc-pair gains: q_gain[j, n] = S[j, q_cols[j, n]] scattered
    # onto the neighbor column.
    contrib = jnp.where(ell.q_mask, ell.q_gain, 0.0)
    asso_in = jnp.zeros(ell.Kp, ell.q_gain.dtype).at[ell.q_cols].add(contrib)
    return jnp.where(ell.mask, base + asso_in, 0.0)


@jax.jit
def asso_degree_scores(ell: EllState) -> jnp.ndarray:
    """MAX_ASSO rank: association degree (``gm.py:81``)."""
    return jnp.where(ell.mask, jnp.sum(ell.q_mask, axis=1),
                     0).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("Z_pad",))
def _pack_by_scores_ell(ell: EllState, scores, Z, key, Z_pad: int):
    """Deterministic score order + lowest-slot-first preference = the
    reference slot-major greedy (see module docstring)."""
    order = jnp.argsort(-jnp.where(ell.mask, scores, -jnp.inf))
    pref = jnp.broadcast_to(jnp.arange(Z_pad, dtype=jnp.int32)[:, None],
                            (Z_pad, ell.Kp))
    slot_of, rem, assigned = _greedy_assign_ell(ell, order, pref, Z, Z_pad)
    # Slots fill lowest-first, so on success the used-slot count is the
    # reference's ZZ (gm.py:57-58 break).
    ZZ = jnp.where(rem == 0,
                   jnp.max(jnp.where(ell.mask, slot_of, -1)) + 1, Z)
    fill = jax.random.randint(key, (ell.Kp,), 0, jnp.maximum(ZZ, 1),
                              jnp.int32)
    z_vec = jnp.where(assigned, slot_of, fill)
    z_vec = jnp.where(ell.mask, z_vec, 0)
    return z_vec, ZZ, rem


@functools.partial(jax.jit, static_argnames=("Z_pad",))
def _pack_random_ell(ell: EllState, Z, key, Z_pad: int):
    """MAX_RAND (``gm.py:131-200``): random user order + random slot
    preference, same feasibility checks."""
    k1, k2, k3 = jax.random.split(key, 3)
    order = jax.random.permutation(
        k1, jnp.argsort(~ell.mask))        # random order, padded users last
    pref_scores = jax.random.uniform(k2, (Z_pad, ell.Kp))
    pref = jnp.argsort(jnp.argsort(-pref_scores, axis=0), axis=0)
    slot_of, rem, assigned = _greedy_assign_ell(ell, order, pref, Z, Z_pad)
    fill = jax.random.randint(k3, (ell.Kp,), 0, jnp.maximum(Z, 1), jnp.int32)
    z_vec = jnp.where(assigned, slot_of, fill)
    z_vec = jnp.where(ell.mask, z_vec, 0)
    return z_vec, rem


def _z_pad_for(ell: EllState, Z: int) -> int:
    return max(default_z_pad_ell(ell), ((Z + 15) // 16) * 16)


class _ScoreHeuristicEll(StatsObject):
    _seed = 777

    @classmethod
    def _scores(cls, ell: EllState) -> jnp.ndarray:
        raise NotImplementedError

    @classmethod
    def run(cls, Z: int, ell: EllState, nattempt: int = 1,
            not_Z_bound: bool = False, Z_pad: int = None
            ) -> Tuple[np.ndarray, int, int]:
        # nattempt accepted for interface parity; the rank is deterministic,
        # so every attempt coincides (see heuristics._greedy_pack_slot_major).
        key = jax.random.PRNGKey(cls._seed)
        if not_Z_bound:
            # Grow the slot budget until everyone fits (gm.py:22-23) without
            # ever allocating a [K, Kp] buffer: doubling host loop.
            Z_try = _z_pad_for(ell, 2)
            while True:
                z_vec, ZZ, rem = _pack_by_scores_ell(
                    ell, cls._scores(ell), jnp.int32(Z_try), key,
                    Z_pad=Z_try)
                if int(rem) == 0 or Z_try >= ell.K:
                    break
                Z_try = min(2 * Z_try, ((ell.K + 15) // 16) * 16)
            return np.asarray(z_vec)[: ell.K], int(ZZ), int(rem)
        if Z_pad is None:
            Z_pad = _z_pad_for(ell, Z)
        z_vec, ZZ, rem = _pack_by_scores_ell(ell, cls._scores(ell),
                                             jnp.int32(Z), key, Z_pad=Z_pad)
        return np.asarray(z_vec)[: ell.K], int(ZZ), int(rem)


class MAX_GAIN_ELL(_ScoreHeuristicEll):
    @classmethod
    def _scores(cls, ell: EllState):
        return incoming_gain_scores(ell)


class MAX_ASSO_ELL(_ScoreHeuristicEll):
    @classmethod
    def _scores(cls, ell: EllState):
        return asso_degree_scores(ell)


class MAX_RAND_ELL(StatsObject):
    @classmethod
    def run(cls, Z: int, ell: EllState, nattempt: int = 1,
            Z_pad: int = None) -> Tuple[np.ndarray, int, int]:
        key = jax.random.PRNGKey(4242)
        if Z_pad is None:
            Z_pad = _z_pad_for(ell, Z)
        z_vec, rem = _pack_random_ell(ell, jnp.int32(Z), key, Z_pad=Z_pad)
        return np.asarray(z_vec)[: ell.K], Z, int(rem)
