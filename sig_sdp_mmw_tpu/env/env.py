"""WTSN scenario generator + evaluator, vectorized in JAX.

Re-implements the behavior of the reference environment
(``sim_src/env/env.py``) as pure, jittable, ``vmap``-able functions over a
static geometry, plus a thin stateful wrapper class :class:`WirelessEnv` with
the reference's API surface (``generate_S_Q_hmax``, ``evaluate_sinr``,
``evaluate_bler``, ``evaluate_pckl``, ``rand_user_mobility``).

Key re-designs vs the reference:

* all per-slot / per-AP Python loops of the evaluator
  (``env.py:198-224``) become dense masked one-shot computations — the
  same-slot interference sum is a masked matvec and the per-(AP, slot)
  "strongest user wins" rule is a pairwise dominance test, so the whole
  evaluation jits and ``vmap``s over scenario batches;
* randomness uses explicit ``jax.random`` keys (three independent streams
  mirroring the reference's ``rand_gen_loc/fad/mob``, ``env.py:13-15``) —
  distributional parity, not bit parity;
* the generator emits the padded static-shape :class:`SigState`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sig_sdp_mmw_tpu.core.problem import SigState, state_from_arrays, _round_up
from sig_sdp_mmw_tpu.env import phy


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Scenario constants (reference ctor args, ``env.py:12-37``)."""

    cell_edge: float = 20.0
    cell_size: int = 20
    sta_density_per_1m2: float = 5e-3
    fre_Hz: float = 4e9
    txp_dbm_hi: float = 5.0
    txp_offset: float = 2.0
    min_s_n_ratio: float = 0.1
    packet_bit: float = 800.0
    bandwidth: float = 5e6
    slot_time: float = 1.25e-4
    max_err: float = 1e-5

    @property
    def grid_edge(self) -> float:
        return self.cell_edge * self.cell_size

    @property
    def n_ap(self) -> int:
        return int(self.cell_size ** 2)

    @property
    def n_sta(self) -> int:
        return int(self.cell_size ** 2 * (self.sta_density_per_1m2 * self.cell_edge ** 2))

    @property
    def min_sinr(self) -> float:
        return phy.min_sinr_dec(self.packet_bit, self.bandwidth, self.slot_time,
                                self.max_err)

    @property
    def min_sinr_db(self) -> float:
        return phy.bisection_min_sinr_db(self.packet_bit, self.bandwidth,
                                         self.slot_time, self.max_err)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def ap_grid(p: EnvParams) -> jnp.ndarray:
    """AP positions on a cell_size x cell_size grid (``env.py:52-56``).

    AP index a = i*cell_size + j sits at (x[j], y[i]) — matches the
    reference's ``meshgrid`` + ravel ordering.
    """
    offset = p.cell_edge / 2.0
    x = np.linspace(offset, p.grid_edge - offset, p.cell_size)
    xx, yy = np.meshgrid(x, x)
    return jnp.asarray(np.stack([xx.ravel(), yy.ravel()], axis=1), dtype=jnp.float32)


def sample_sta_locs(key: jax.Array, p: EnvParams) -> jax.Array:
    return jax.random.uniform(key, (p.n_sta, 2), minval=0.0, maxval=p.grid_edge)


def sample_sta_dirs(key: jax.Array, n: int) -> jax.Array:
    d = jax.random.normal(key, (n, 2))
    return d / jnp.linalg.norm(d, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# Channel state
# ---------------------------------------------------------------------------

def rxpr_unthresholded(sta_locs: jax.Array, aps: jax.Array, p: EnvParams) -> jax.Array:
    """[K, A] received-power-to-noise ratios under per-user power control.

    Mirrors ``_compute_txp`` + ``_compute_state_real`` (``env.py:136-166``):
    each user aims ``min_sinr + txp_offset`` (dB) at its strongest AP.
    """
    dis = jnp.linalg.norm(sta_locs[:, None, :] - aps[None, :, :], axis=-1)
    loss = phy.fre_dis_to_loss_db(p.fre_Hz, dis)              # [K, A]
    gain = -loss
    smax = jnp.max(gain, axis=1)                              # [K]
    noise = phy.noise_dbm(p.bandwidth)
    txp = (p.min_sinr_db - (smax - noise)
           + 10.0 * math.log10(p.txp_offset))[:, None]        # [K, 1]
    rxpr_db = txp - loss - noise
    return 10.0 ** (rxpr_db / 10.0)


def threshold_rxpr(rxpr: jax.Array, p: EnvParams) -> jax.Array:
    """Sparsify: ratios below ``min_s_n_ratio`` are zeroed (``env.py:151``)."""
    return jnp.where(rxpr < p.min_s_n_ratio, 0.0, rxpr)


def state_arrays_from_rxpr(rxpr: jax.Array, p: EnvParams
                           ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """(S, Q, h_max, asso) from a [K, A] rxpr matrix (``env.py:168-196``).

    S[k, j] = rxpr[k, asso[j]]; Q[i, j] = 1 iff asso_i == asso_j (i != j);
    h_max = diag(S)/min_sinr - 1.
    """
    K = rxpr.shape[0]
    asso = jnp.argmax(rxpr, axis=1)                            # [K]
    S = rxpr[:, asso]                                          # [K, K]
    Q = (asso[:, None] == asso[None, :]).astype(rxpr.dtype)
    Q = Q * (1.0 - jnp.eye(K, dtype=rxpr.dtype))
    h_max = jnp.diagonal(S) / p.min_sinr - 1.0
    return S, Q, h_max, asso


# ---------------------------------------------------------------------------
# Evaluation (unthresholded channel, winner-takes-AP rule)
# ---------------------------------------------------------------------------

def evaluate_sinr_from_rxpr(rxpr_real: jax.Array, z: jax.Array, p: EnvParams
                            ) -> jax.Array:
    """Per-user SINR of assignment ``z`` (``env.py:198-224``), vectorized.

    1. same-slot interference: for user k, sum of other same-slot users'
       gain at k's AP (rows of S^T with zero diagonal);
    2. per-(AP, slot) winner rule: within each association+slot group only the
       strongest user keeps its SINR, the rest drop to 1e-3 (first index wins
       ties — matching ``np.ma.argmax``).
    """
    S, _, _, asso = state_arrays_from_rxpr(rxpr_real, p)
    K = S.shape[0]
    eye = jnp.eye(K, dtype=bool)

    same_slot = (z[:, None] == z[None, :]) & ~eye
    # S^T row k = gains of all users at k's AP.
    interference = jnp.sum(jnp.where(same_slot, S.T, 0.0), axis=1)
    signal = jnp.diagonal(S)
    sinr = signal / (interference + 1.0)

    same_group = same_slot & (asso[:, None] == asso[None, :])
    idx = jnp.arange(K)
    beaten = (sinr[None, :] > sinr[:, None]) | (
        (sinr[None, :] == sinr[:, None]) & (idx[None, :] < idx[:, None]))
    loses = jnp.any(same_group & beaten, axis=1)
    return jnp.where(loses, 1e-3, sinr)


def evaluate_bler_from_sinr(sinr: jax.Array, p: EnvParams) -> jax.Array:
    return phy.polyanskiy_model(sinr, p.packet_bit, p.bandwidth, p.slot_time)


# ---------------------------------------------------------------------------
# Mobility
# ---------------------------------------------------------------------------

def mobility_substep(key: jax.Array, sta_locs: jax.Array, sta_dirs: jax.Array,
                     speed_m_s: float, resolution_us: float, grid_edge: float
                     ) -> Tuple[jax.Array, jax.Array]:
    """One mobility step of every user (``env.py:74-87``): advance along the
    unit direction; users that would exit the grid stay put and redraw a
    random direction."""
    step = sta_dirs * speed_m_s * resolution_us / 1e6
    cand = sta_locs + step
    ok = jnp.all((cand >= 0.0) & (cand <= grid_edge), axis=1, keepdims=True)
    new_locs = jnp.where(ok, cand, sta_locs)
    rnd = jax.random.normal(key, sta_dirs.shape)
    rnd = rnd / jnp.linalg.norm(rnd, axis=1, keepdims=True)
    new_dirs = jnp.where(ok, sta_dirs, rnd)
    return new_locs, new_dirs


# ---------------------------------------------------------------------------
# Stateful wrapper (reference API surface)
# ---------------------------------------------------------------------------

class WirelessEnv:
    """Reference-compatible environment object (``sim_src/env/env.py:5``).

    Holds geometry + RNG state; all computation delegates to the pure
    functions above (jitted on first use).
    """

    def __init__(self, cell_edge: float = 20.0, cell_size: int = 20,
                 sta_density_per_1m2: float = 5e-3, fre_Hz: float = 4e9,
                 txp_dbm_hi: float = 5.0, txp_offset: float = 2.0,
                 min_s_n_ratio: float = 0.1, packet_bit: float = 800.0,
                 bandwidth: float = 5e6, slot_time: float = 1.25e-4,
                 max_err: float = 1e-5, seed: int = 1,
                 pad_to: Optional[int] = None):
        self.params = EnvParams(
            cell_edge=cell_edge, cell_size=cell_size,
            sta_density_per_1m2=sta_density_per_1m2, fre_Hz=fre_Hz,
            txp_dbm_hi=txp_dbm_hi, txp_offset=txp_offset,
            min_s_n_ratio=min_s_n_ratio, packet_bit=packet_bit,
            bandwidth=bandwidth, slot_time=slot_time, max_err=max_err)
        self.seed = seed
        key = jax.random.PRNGKey(seed)
        # Three independent streams mirroring rand_gen_loc/fad/mob.
        self.key_loc = jax.random.fold_in(key, 0)
        self.key_fad = jax.random.fold_in(key, 1)
        self.key_mob = jax.random.fold_in(key, 2)
        self._mob_counter = 0

        self.ap_locs = ap_grid(self.params)
        self.sta_locs = sample_sta_locs(self.key_loc, self.params)
        self.sta_dirs = sample_sta_dirs(self.key_mob, self.params.n_sta)
        self.pad_to = pad_to

    # -- reference-compatible properties ------------------------------------
    @property
    def n_sta(self) -> int:
        return self.params.n_sta

    @property
    def n_ap(self) -> int:
        return self.params.n_ap

    @property
    def min_sinr(self) -> float:
        return self.params.min_sinr

    @property
    def slot_time(self) -> float:
        return self.params.slot_time

    # -- state generation ----------------------------------------------------
    def rxpr(self, real: bool = False) -> jax.Array:
        r = rxpr_unthresholded(self.sta_locs, self.ap_locs, self.params)
        return r if real else threshold_rxpr(r, self.params)

    def generate_state(self, real: bool = False) -> SigState:
        S, Q, h_max, _ = state_arrays_from_rxpr(self.rxpr(real), self.params)
        pad = self.pad_to if self.pad_to is not None else _round_up(self.n_sta, 8)
        return state_from_arrays(np.asarray(S), np.asarray(Q), np.asarray(h_max),
                                 pad_to=pad)

    # Reference name (``env.py:168``); returns the static-shape state container.
    def generate_S_Q_hmax(self, real: bool = False) -> SigState:
        return self.generate_state(real=real)

    # -- evaluation -----------------------------------------------------------
    def evaluate_sinr(self, z, Z=None) -> np.ndarray:
        z = jnp.asarray(np.asarray(z)[: self.n_sta].astype(np.int32))
        return np.asarray(evaluate_sinr_from_rxpr(self.rxpr(real=True), z, self.params))

    def evaluate_bler(self, z, Z=None) -> np.ndarray:
        sinr = self.evaluate_sinr(z, Z)
        return np.asarray(evaluate_bler_from_sinr(jnp.asarray(sinr), self.params))

    def evaluate_pckl(self, z, Z=None) -> np.ndarray:
        bler = self.evaluate_bler(z, Z)
        self._mob_counter += 1
        key = jax.random.fold_in(self.key_fad, self._mob_counter)
        return np.asarray(jax.random.bernoulli(key, jnp.asarray(bler)).astype(np.int32))

    # -- mobility -------------------------------------------------------------
    def rand_user_mobility(self, mobility_in_meter_s: float = 0.0, t_us: float = 0,
                           resolution_us: float = 1.0) -> None:
        if mobility_in_meter_s == 0.0 or t_us == 0.0:
            return
        n_step = math.ceil(t_us / resolution_us)
        locs, dirs = self.sta_locs, self.sta_dirs
        for _ in range(n_step):
            self._mob_counter += 1
            key = jax.random.fold_in(self.key_mob, self._mob_counter)
            locs, dirs = _mobility_substep_jit(
                key, locs, dirs, float(mobility_in_meter_s),
                float(resolution_us), float(self.params.grid_edge))
        self.sta_locs, self.sta_dirs = locs, dirs


_mobility_substep_jit = jax.jit(mobility_substep, static_argnums=(3, 4, 5))
