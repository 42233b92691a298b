"""Scenario batching + speculative parallel-Z search.

Two parallel modes the reference cannot express:

* :func:`solve_scenarios_batched` — ``vmap`` the whole MMW solve over a
  stacked batch of scenario states, sharded over a (batch, graph) mesh: the
  batch axis spreads independent instances across devices (the reference's
  seed loops), the graph axis row-partitions the K×K state inside each
  instance (GSPMD inserts the collectives);

* :class:`ParallelProbeSearch` — because Z is a *traced* scalar in
  :func:`sig_sdp_mmw_tpu.models.mmw.mmw_solve`, candidate slot counts vmap
  too: solve ALL Z in [lb, ub] simultaneously and take the smallest feasible
  one.  This replaces the reference's sequential binary search
  (``sim_src/alg/binary_search_relaxation.py:44-72``) with one batched solve
  + one batched rounding — a latency win whenever devices are idle, and
  the answer to the search being inherently sequential.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sig_sdp_mmw_tpu.core.problem import SigState
from sig_sdp_mmw_tpu.models.mmw import mmw_solve
from sig_sdp_mmw_tpu.models.rounding import _rounding_batch, _default_z_pad
from sig_sdp_mmw_tpu.utils.stats import StatsObject


def stack_states(states: Sequence[SigState]) -> SigState:
    """Stack equal-padded states into one batched SigState pytree [B, ...]."""
    K = states[0].K
    if any(s.Kp != states[0].Kp for s in states):
        raise ValueError("all states must share Kp (use a common pad_to)")
    return SigState(
        S=jnp.stack([s.S for s in states]),
        Q=jnp.stack([s.Q for s in states]),
        h_max=jnp.stack([s.h_max for s in states]),
        mask=jnp.stack([s.mask for s in states]),
        K=K,
    )


def _state_sharding(mesh: Mesh, batched: bool, K: int):
    b = ("batch",) if batched else ()
    return SigState(
        S=NamedSharding(mesh, P(*b, "graph", None)),
        Q=NamedSharding(mesh, P(*b, "graph", None)),
        h_max=NamedSharding(mesh, P(*b, "graph")),
        mask=NamedSharding(mesh, P(*b, "graph")),
        K=K,  # static metadata must match the target pytree
    )


def solve_scenarios_batched(states: SigState, Z, *, nit: int, eta: float,
                            D_pad: int, rank_pad: int, key: jax.Array,
                            mesh: Optional[Mesh] = None,
                            rank_radio: int = 2,
                            lanczos_m: Optional[int] = None):
    """vmap of :func:`mmw_solve` over the leading batch axis of ``states``.

    ``Z`` may be a scalar or a [B] vector (per-instance slot counts).
    With a mesh, inputs are sharded (batch, graph) and the compiled program
    runs SPMD across the mesh.
    """
    B = states.S.shape[0]
    Zv = jnp.broadcast_to(jnp.asarray(Z, states.S.dtype), (B,))
    keys = jax.random.split(key, B)

    def one(state, Z, key):
        return mmw_solve(state, Z, nit=nit, eta=eta, rank_radio=rank_radio,
                         D_pad=D_pad, rank_pad=rank_pad, key=key,
                         lanczos_m=lanczos_m)

    fn = jax.jit(jax.vmap(one))
    if mesh is not None:
        states = jax.device_put(
            states, _state_sharding(mesh, batched=True, K=states.K))
    return fn(states, Zv, keys)


class ParallelProbeSearch(StatsObject):
    """Solve every candidate Z in [lb, ub] at once; return the best feasible.

    Drop-in alternative to
    :class:`sig_sdp_mmw_tpu.models.search.BinarySearchRelaxation` — same
    ``run(state) -> (z_vec, Z, rem)`` contract, same bound semantics.
    """

    def __init__(self, nit: int = 100, eta: float = 0.05, rank_radio: int = 2,
                 nattempt: int = 10, seed: int = 0,
                 lanczos_m: Optional[int] = None,
                 max_probes: Optional[int] = None):
        self.nit = nit
        self.eta = eta
        self.rank_radio = rank_radio
        self.nattempt = nattempt
        self.lanczos_m = lanczos_m
        self.max_probes = max_probes
        self._key = jax.random.PRNGKey(seed)
        self._ncall = 0

    def run(self, state: SigState):
        from sig_sdp_mmw_tpu.models.search import BinarySearchRelaxation

        bs = BinarySearchRelaxation()
        lb, ub = bs.set_bounds(state)
        self._ncall += 1
        key = jax.random.fold_in(self._key, self._ncall)

        tic = self._get_tic()
        lo, hi = lb, ub           # lo..hi = window still to resolve
        best = None               # (z_vec, Z) of smallest feasible so far
        rounds = 0
        while True:
            candidates = np.arange(lo, hi + 1)
            if self.max_probes is not None and candidates.size > self.max_probes:
                candidates = np.unique(
                    np.linspace(lo, hi, self.max_probes).round().astype(int))
            rounds += 1
            z_vecs, rems, Zs = self._probe(
                state, candidates, jax.random.fold_in(key, rounds))

            feas = np.where(rems == 0)[0]
            if feas.size:
                i = int(feas[np.argmin(Zs[feas])])
                if best is None or Zs[i] < best[1]:
                    best = (z_vecs[i][: state.K], int(Zs[i]))
                # Refine between the largest infeasible candidate below the
                # best and the best itself.
                below = Zs[(rems != 0) & (Zs < best[1])]
                lo = int(below.max()) + 1 if below.size else lo
                hi = best[1] - 1
                if lo > hi or best[1] == lb:
                    break
                # All candidates in (lo, hi) already probed? then done.
                if np.all(np.isin(np.arange(lo, hi + 1), Zs)):
                    break
            else:
                if best is not None:
                    break
                # Nothing feasible in the window: shift up, like the
                # reference's both-bounds-infeasible case
                # (binary_search_relaxation.py:65-67).
                lo, hi = hi + 1, hi + max(hi - lo, 1)
                if lo > state.K:
                    break

        tim = self._get_tim(tic)
        self._add_np_log("pp_search", 0, np.array([lb, ub, rounds, tim]))
        if best is not None:
            return best[0], best[1], 0
        # Give up on the parallel path; sequential fallback.
        from sig_sdp_mmw_tpu.models.mmw import MMW

        bs.feasibility_check_alg = MMW(nit=self.nit, eta=self.eta,
                                       rank_radio=self.rank_radio)
        return bs.run(state)

    def _probe(self, state: SigState, candidates: np.ndarray, key):
        n = candidates.size
        D_pad = ((int(candidates.max()) * self.rank_radio + 15) // 16) * 16
        rank_pad = min(D_pad, state.Kp - 1)
        Z_pad = max(_default_z_pad(state),
                    ((int(candidates.max()) + 15) // 16) * 16)

        states = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n,) + x.shape) if hasattr(x, "shape")
            else x, state)
        out = solve_scenarios_batched(
            states, jnp.asarray(candidates, jnp.float32), nit=self.nit,
            eta=self.eta, D_pad=D_pad, rank_pad=rank_pad, key=key,
            rank_radio=self.rank_radio, lanczos_m=self.lanczos_m)

        rkeys = jax.random.split(jax.random.fold_in(key, 1), n)

        @functools.partial(jax.jit, static_argnames=("Z_pad", "nattempt"))
        def round_all(states, gXs, Zs, keys, Z_pad, nattempt):
            return jax.vmap(
                lambda st, gX, Z, k: _rounding_batch(st, gX, Z, k, Z_pad,
                                                     nattempt)
            )(states, gXs, Zs, keys)

        z_vecs, rems = round_all(states, out.X_half,
                                 jnp.asarray(candidates, jnp.int32), rkeys,
                                 Z_pad, self.nattempt)
        return np.asarray(z_vecs), np.asarray(rems), candidates


class ParallelProbeSearchEll(StatsObject):
    """Speculative multi-section Z search on the SPARSE (ELL/BCSR) backend —
    the large-K counterpart of :class:`ParallelProbeSearch`.

    At K~100k one MMW probe costs tens of seconds, so the reference's
    sequential bisection (``binary_search_relaxation.py:44-72``) pays
    ~log2(window) probe latencies end to end.  Here each WAVE solves
    ``wave`` candidate Z values simultaneously — one vmap over the traced Z
    (the state and BCSR operands are broadcast, NOT replicated per
    candidate) — then the window narrows to the gap between the largest
    infeasible and the smallest feasible candidate.  A wave of W candidates
    splits the window into W-1 segments, so the search resolves in
    ~log_{W-1}(window) waves instead of log2(window) probes.

    WHEN IT PAYS: the wave's W probes must actually run in parallel —
    i.e. the batch axis sharded across devices, or per-probe work too
    small to fill one device.  On ONE device at K=100k each probe is
    expected to fill it already, so a wave would cost ~W probe-times and
    plain bisection would be faster (not yet measured on the GPU); this
    class is the multi-device search skeleton, tested on one device for
    answer-equality.

    Same ``run(ell) -> (z_vec, Z, rem)`` contract as
    :class:`sig_sdp_mmw_tpu.models.search.BinarySearchRelaxation`.
    """

    def __init__(self, nit: int = 100, eta: float = 0.05, rank_radio: int = 2,
                 nattempt: int = 3, seed: int = 0,
                 lanczos_m: Optional[int] = None, wave: int = 4,
                 use_bcsr: bool = False, spmm_row_chunk: Optional[int] = None,
                 d_pad_cap: Optional[int] = None,
                 wave_segment: Optional[int] = None):
        self.nit = nit
        self.eta = eta
        self.rank_radio = rank_radio
        self.nattempt = nattempt
        self.lanczos_m = lanczos_m
        self.wave = max(2, wave)
        self.use_bcsr = use_bcsr
        self.spmm_row_chunk = spmm_row_chunk
        # Cap on the sketch width D_pad.  Early waves probe Z near the
        # window's upper bound, where the full D = Z*rank_radio sketch is a
        # memory multiplier (wave x [m, Kp, D] Lanczos bases) but adds
        # little: high-Z probes are the EASY feasibility checks, and the
        # solver's D_act clamp makes a truncated sketch a valid (slightly
        # coarser) relaxation probe.
        self.d_pad_cap = d_pad_cap
        # Iterations per device execution for the wave solve.  A wave runs
        # wave*nit solver iterations in ONE execution; this splits it into
        # carry-passing segments of short executions — same mechanism as
        # tools/million_link.py --segment.  None = single-shot.
        self.wave_segment = wave_segment
        self._key = jax.random.PRNGKey(seed)
        self._ncall = 0
        self._bcsr = None
        self._solve_cache = {}
        self._round_cache = {}

    def prepare(self, ell, S_csr=None, Q_csr=None, block: int = 128,
                **bcsr_kw):
        """Precompute BCSR operands (same contract as ``MMWEll.prepare``)."""
        if self.use_bcsr:
            from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

            if S_csr is None:
                raise ValueError("use_bcsr=True needs the scipy (S, Q) pair")
            self._bcsr = bcsr_operands_from_state(S_csr, Q_csr, block=block,
                                                  **bcsr_kw)
        return self

    # -- jit caches ---------------------------------------------------------

    def _solve_wave_fn(self, D_pad, rank_pad):
        # The state and operands are ARGUMENTS vmapped with in_axes=None
        # (broadcast, not replicated) — closing over concrete device arrays
        # would embed them as literal constants in the lowered module,
        # which a remote-compile transport rejects at 100k+ scale.
        sig = (D_pad, rank_pad)
        if sig not in self._solve_cache:
            from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell

            def one(e, b, Z, key):
                return mmw_solve_ell(
                    e, Z, nit=self.nit, eta=self.eta,
                    rank_radio=self.rank_radio, D_pad=D_pad,
                    rank_pad=rank_pad, key=key, lanczos_m=self.lanczos_m,
                    bcsr=b, spmm_row_chunk=self.spmm_row_chunk)

            self._solve_cache[sig] = jax.jit(
                jax.vmap(one, in_axes=(None, None, 0, 0)))
        return self._solve_cache[sig]

    def _seg_wave_fns(self, D_pad, rank_pad, nsteps):
        """(first, mid, fin) vmapped segmented wave solvers."""
        sig = ("seg", D_pad, rank_pad, nsteps)
        if sig not in self._solve_cache:
            from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell

            kw = dict(nit=self.nit, eta=self.eta,
                      rank_radio=self.rank_radio, D_pad=D_pad,
                      rank_pad=rank_pad, lanczos_m=self.lanczos_m,
                      spmm_row_chunk=self.spmm_row_chunk)

            def first(e, b, Z, key, i0):
                return mmw_solve_ell(e, Z, key=key, bcsr=b, carry_in=None,
                                     it_start=i0, num_steps=nsteps,
                                     return_carry=True, **kw)

            def mid(e, b, Z, key, c, i0):
                return mmw_solve_ell(e, Z, key=key, bcsr=b, carry_in=c,
                                     it_start=i0, num_steps=nsteps,
                                     return_carry=True, **kw)

            def fin(e, b, Z, key, c):
                return mmw_solve_ell(e, Z, key=key, bcsr=b, carry_in=c,
                                     it_start=self.nit, num_steps=0, **kw)

            self._solve_cache[sig] = (
                jax.jit(jax.vmap(first, in_axes=(None, None, 0, 0, None))),
                jax.jit(jax.vmap(mid, in_axes=(None, None, 0, 0, 0, None))),
                jax.jit(jax.vmap(fin, in_axes=(None, None, 0, 0, 0))))
        return self._solve_cache[sig]

    def _solve_wave(self, ell, Zv, skeys, D_pad, rank_pad):
        ns = self.wave_segment
        if not ns or ns >= self.nit:
            return self._solve_wave_fn(D_pad, rank_pad)(ell, self._bcsr,
                                                        Zv, skeys)
        nfull = self.nit // ns
        first, mid, fin = self._seg_wave_fns(D_pad, rank_pad, ns)
        c = first(ell, self._bcsr, Zv, skeys, 0)
        float(c["eaD"][0, 0])          # execution boundary (see million_link)
        for s in range(1, nfull):
            c = mid(ell, self._bcsr, Zv, skeys, c, s * ns)
            float(c["eaD"][0, 0])
        rem = self.nit - nfull * ns
        if rem:
            _, mid_r, _ = self._seg_wave_fns(D_pad, rank_pad, rem)
            c = mid_r(ell, self._bcsr, Zv, skeys, c, nfull * ns)
            float(c["eaD"][0, 0])
        return fin(ell, self._bcsr, Zv, skeys, c)

    def _round_wave_fn(self, Z_pad):
        if Z_pad not in self._round_cache:
            from sig_sdp_mmw_tpu.models.rounding_ell import _rounding_single_ell

            def one(e, gX, Z, key):
                return _rounding_single_ell(e, gX, Z, key, Z_pad)

            self._round_cache[Z_pad] = jax.jit(
                jax.vmap(one, in_axes=(None, 0, 0, 0)))
        return self._round_cache[Z_pad]

    # -- search -------------------------------------------------------------

    def _wave(self, ell, cands: np.ndarray, key):
        """Solve + round one wave of candidates; returns (z_vecs, rems)."""
        from sig_sdp_mmw_tpu.models.rounding_ell import default_z_pad_ell

        zmax = int(cands.max())
        need = max(32, zmax * self.rank_radio)
        D_pad = 1 << (need - 1).bit_length()
        cap = max(((ell.Kp - 1) // 16) * 16, 1)
        if self.d_pad_cap is not None:
            cap = min(cap, self.d_pad_cap)
        D_pad = min(D_pad, cap)
        rank_pad = min(D_pad, ell.Kp - 1)
        Z_pad = default_z_pad_ell(ell, zmax)

        Zv = jnp.asarray(cands, jnp.float32)
        skeys = jax.random.split(key, cands.size)
        out = self._solve_wave(ell, Zv, skeys, D_pad, rank_pad)

        from sig_sdp_mmw_tpu.models.rounding_ell import (
            _BATCH_ATTEMPT_MAX_KP, _rounding_single_ell)

        batch_round = ell.Kp <= _BATCH_ATTEMPT_MAX_KP
        if batch_round:
            rnd = self._round_wave_fn(Z_pad)
        Zi = jnp.asarray(cands, jnp.int32)
        best_z = None
        best_rem = None
        for attempt in range(self.nattempt):
            rkeys = jax.random.split(jax.random.fold_in(key, 1000 + attempt),
                                     cands.size)
            if batch_round:
                z_vecs, rems = rnd(ell, out.X_half, Zi, rkeys)
            else:
                # One device execution per candidate: a vmapped wave of
                # K~100k sequential greedy scans would be one multi-minute
                # execution, which capped runtimes kill (see
                # _BATCH_ATTEMPT_MAX_KP).
                zs, rs = [], []
                for i in range(cands.size):
                    z1, r1 = _rounding_single_ell(ell, out.X_half[i], Zi[i],
                                                  rkeys[i], Z_pad)
                    zs.append(z1)
                    rs.append(r1)
                z_vecs, rems = jnp.stack(zs), jnp.stack(rs)
            z_vecs, rems = np.asarray(z_vecs), np.asarray(rems)
            if best_z is None:
                best_z, best_rem = z_vecs, rems
            else:
                better = rems < best_rem
                best_z = np.where(better[:, None], z_vecs, best_z)
                best_rem = np.minimum(rems, best_rem)
            if best_rem[0] == 0:
                # cands is sorted ascending: once the SMALLEST candidate is
                # feasible nothing in this wave can improve the answer.
                # (Candidates below a larger feasible Z must keep their full
                # nattempt budget — the sequential reference grants every
                # probe all attempts, and an early exit here would record
                # them permanently infeasible in `probed`.)
                break
        return best_z, best_rem

    def run(self, ell):
        lb, ub = ell.degree_bounds()
        self._ncall += 1
        key = jax.random.fold_in(self._key, self._ncall)

        tic = self._get_tic()
        probed = {}               # Z -> (rem, z_vec)
        lo, hi = lb, ub
        waves = 0
        best = None               # (Z, z_vec) smallest feasible
        while True:
            cands = np.unique(np.linspace(lo, hi, self.wave).round()
                              .astype(int))
            cands = cands[~np.isin(cands, list(probed))]
            if cands.size == 0:
                break
            waves += 1
            z_vecs, rems = self._wave(ell, cands,
                                      jax.random.fold_in(key, waves))
            for i, Z in enumerate(cands):
                probed[int(Z)] = (int(rems[i]), z_vecs[i])
            feas = sorted(Z for Z, (r, _) in probed.items() if r == 0)
            if feas:
                bz = feas[0]
                best = (bz, probed[bz][1])
                below = [Z for Z, (r, _) in probed.items()
                         if r != 0 and Z < bz]
                lo = max(below) + 1 if below else lo
                hi = bz - 1
                if lo > hi:
                    break
            else:
                # Everything infeasible: slide the window up (reference's
                # both-bounds-infeasible case).
                lo, hi = hi + 1, hi + max(hi - lo, 1)
                if lo > ell.K:
                    break
            self._printalltime(
                f"pp-ell wave={waves} window=[{lo},{hi}] "
                f"probed={sorted(probed)} best={best[0] if best else None}")

        tim = self._get_tim(tic)
        self._add_np_log("pp_search", 0, np.array([lb, ub, waves, tim]))
        if best is None:
            raise RuntimeError("speculative search found no feasible Z up "
                               f"to K={ell.K}")
        Z = best[0]
        return np.asarray(best[1])[: ell.K], Z, 0
