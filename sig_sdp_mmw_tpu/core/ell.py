"""Static-shape ELL sparse graph container — the million-link state ABI.

The dense [K, K] backend (:mod:`sig_sdp_mmw_tpu.core.problem`) is ideal up to
a few thousand users; the reference's own scale tops out near K~1000 (SURVEY
§0).  The north-star configs (BASELINE.json: 100k-1M links) need sparse
state.  The sparse container is **padded ELL**: every row stores exactly
``deg_pad`` (column, value) slots, padding with (0, 0.0) — a zero value
kills the padded contribution in every gather-accumulate, so no masks are
needed on the hot path and all shapes are static.

Arrays (Kp rows, all padded):

* ``s_cols/s_vals``   [Kp, degS]  — S tilde rows (S^T, association pairs and
  diagonal removed: the interference operator of ``mmw.py:26-41``);
* ``st_cols/st_vals`` [Kp, degS]  — its transpose (for S̃^T matvecs);
* ``a_i/a_j``         [E_pad]     — association upper-tri edge list
  (the F constraints), with ``a_mask``;
* ``q_cols/q_eidx``   [Kp, degQ]  — per-row association neighbors + pointer
  into the edge array (so the LF matvec is gather-only, no scatter);
* ``diag_S``          [Kp]        — own-AP gains (h_max derivation);
* ``h_max, mask``     [Kp].

Z-dependent quantities (norm_H) are computed inside the solver.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllState:
    s_cols: jax.Array   # [Kp, degS] int32
    s_vals: jax.Array   # [Kp, degS]
    st_cols: jax.Array  # [Kp, degS] int32 (transpose)
    st_vals: jax.Array  # [Kp, degS]
    s_xw: jax.Array     # [Kp, degS] symmetrization weight (1, 0.5 or 0):
                        # 0.5 where the reverse S̃ edge also exists, so each
                        # undirected pattern edge is counted exactly once
    st_xw: jax.Array    # [Kp, degS] same, for the transpose
    a_i: jax.Array      # [E_pad] int32
    a_j: jax.Array      # [E_pad] int32
    a_mask: jax.Array   # [E_pad] bool
    q_cols: jax.Array   # [Kp, degQ] int32
    q_eidx: jax.Array   # [Kp, degQ] int32 (index into a_* arrays)
    q_mask: jax.Array   # [Kp, degQ] bool
    q_gain: jax.Array   # [Kp, degQ] S values at association positions
                        # (S[k, q_cols[k, n]]): the assoc-pair gains that the
                        # solver strips from S̃ but exact interference
                        # accounting (verify_assignment_ell) still needs
    diag_S: jax.Array   # [Kp]
    h_max: jax.Array    # [Kp]
    mask: jax.Array     # [Kp] bool
    K: int = dataclasses.field(metadata=dict(static=True))
    # Cached binary-search bounds, computed host-side at build time from the
    # CSR matrices the builder already holds, so the search never pulls the
    # device arrays back just to count degrees.  -1 = absent.
    lb_cache: int = dataclasses.field(default=-1, metadata=dict(static=True))
    ub_cache: int = dataclasses.field(default=-1, metadata=dict(static=True))

    @property
    def Kp(self) -> int:
        return self.s_cols.shape[0]

    @property
    def E_pad(self) -> int:
        return self.a_i.shape[0]

    def degree_bounds(self) -> Tuple[int, int]:
        """(lb, ub) for the binary search over Z — reference semantics
        (``sim_src/alg/binary_search_relaxation.py:13-29``) computed from the
        padded ELL arrays without densification:

        lb = max association degree + 1; ub = max row count of the stored
        pattern of ``S + S^T`` after ``setdiag(0)`` + 1.  The off-diagonal
        pattern per row is the union of S̃ out-neighbors, S̃ in-neighbors and
        association neighbors (assoc pairs are always stored in S because
        ``S[i,j] = S[i,i]`` for co-associated users); scipy's ``setdiag(0)``
        keeps an explicit stored zero on the diagonal, hence the +2 replicated
        from :meth:`sig_sdp_mmw_tpu.core.problem.SigState.degree_bounds`.
        """
        if self.lb_cache >= 0 and self.ub_cache >= 0:
            return max(self.lb_cache, 2), max(self.ub_cache, 2, self.lb_cache)
        mask = np.asarray(self.mask)
        lb = self.asso_lower_bound()
        cat = np.concatenate([
            np.where(np.asarray(self.s_vals) != 0, np.asarray(self.s_cols), -1),
            np.where(np.asarray(self.st_vals) != 0, np.asarray(self.st_cols), -1),
            np.where(np.asarray(self.q_mask), np.asarray(self.q_cols), -1),
        ], axis=1)
        cat.sort(axis=1)
        distinct = (cat >= 0) & np.concatenate(
            [np.ones((cat.shape[0], 1), bool), cat[:, 1:] != cat[:, :-1]], axis=1)
        ub = int(distinct.sum(axis=1)[mask].max(initial=0)) + 2
        return max(lb, 2), max(ub, 2, lb)

    def asso_lower_bound(self) -> int:
        """lb = max association degree + 1 (``binary_search_relaxation.py:14-17``)."""
        if self.lb_cache >= 0:
            return self.lb_cache
        q_deg = np.asarray(self.q_mask).sum(axis=1)
        return int(q_deg[np.asarray(self.mask)].max(initial=0)) + 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllSlim:
    """The subset of :class:`EllState` the BLOCK-NATIVE solver actually
    reads — [Kp] and [E_pad] vectors only.  At million-link scale the full
    EllState is ~2.5 GB of ELL index/value arrays that the BCSR path never
    touches; solving against the slim state leaves all of that on the host
    (the full state is only needed later, for rounding/verification).

    ``S_sum``/``row2`` are the S̃ row sums and squared row sums that
    :func:`sig_sdp_mmw_tpu.models.mmw_ell.mmw_solve_ell` otherwise derives
    from ``s_vals`` (norm_H preprocessing, ``mmw.py:26-41``)."""

    S_sum: jax.Array   # [Kp]
    row2: jax.Array    # [Kp]
    a_i: jax.Array     # [E_pad] int32
    a_j: jax.Array     # [E_pad] int32
    a_mask: jax.Array  # [E_pad] bool
    h_max: jax.Array   # [Kp]
    mask: jax.Array    # [Kp] bool
    K: int = dataclasses.field(metadata=dict(static=True))

    @property
    def Kp(self) -> int:
        return self.mask.shape[0]

    @property
    def E_pad(self) -> int:
        return self.a_i.shape[0]


def ell_slim(ell: EllState) -> EllSlim:
    """Slim view of a built EllState (device reductions over s_vals)."""
    return EllSlim(
        S_sum=jnp.sum(ell.s_vals, axis=1),
        row2=jnp.sum(ell.s_vals * ell.s_vals, axis=1),
        a_i=ell.a_i, a_j=ell.a_j, a_mask=ell.a_mask,
        h_max=ell.h_max, mask=ell.mask, K=ell.K)


def ell_slim_from_csr(S_csr, Q_csr, h_max, pad_rows_to: Optional[int] = None,
                      dtype=np.float32) -> EllSlim:
    """Build the slim state straight from the scipy CSR pair — no [Kp, deg]
    ELL arrays are ever materialized (the million-link solve path)."""
    import scipy.sparse

    S = S_csr.tocsr()
    Q = Q_csr.tocsr()
    K = S.shape[0]
    Kp = pad_rows_to or _round_up(K, 8)
    St = build_st_csr(S, Q)
    S_sum = np.zeros(Kp, dtype)
    row2 = np.zeros(Kp, dtype)
    S_sum[:K] = np.asarray(St.sum(axis=1)).ravel()
    row2[:K] = np.asarray(St.multiply(St).sum(axis=1)).ravel()

    Qu = scipy.sparse.triu(Q, k=1).tocoo()
    E = Qu.nnz
    E_pad = _round_up(E, 8)
    a_i = np.zeros(E_pad, np.int32)
    a_j = np.zeros(E_pad, np.int32)
    a_mask = np.zeros(E_pad, bool)
    a_i[:E], a_j[:E], a_mask[:E] = Qu.row, Qu.col, True

    hm = np.zeros(Kp, dtype)
    hm[:K] = np.asarray(h_max, dtype)
    mask = np.zeros(Kp, bool)
    mask[:K] = True
    return EllSlim(S_sum=jnp.asarray(S_sum), row2=jnp.asarray(row2),
                   a_i=jnp.asarray(a_i), a_j=jnp.asarray(a_j),
                   a_mask=jnp.asarray(a_mask), h_max=jnp.asarray(hm),
                   mask=jnp.asarray(mask), K=K)


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def _csr_gather(M, rows, cols):
    """Vectorized ``M[rows[i], cols[i]]`` lookup on a sorted-indices CSR via a
    global row-major key search — O(nnz + q log nnz), no per-entry Python."""
    M = M.tocsr()
    M.sort_indices()
    ncol = M.shape[1]
    row_of = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                       np.diff(M.indptr))
    keys = row_of * ncol + M.indices
    q = np.asarray(rows, np.int64) * ncol + np.asarray(cols, np.int64)
    pos = np.searchsorted(keys, q)
    pos = np.minimum(pos, max(keys.size - 1, 0))
    out = np.zeros(q.size, M.data.dtype)
    if keys.size:
        hit = keys[pos] == q
        out[hit] = M.data[pos[hit]]
    return out


def build_st_csr(S_csr, Q_csr):
    """S tilde as CSR: S^T with association pairs and diagonal removed
    (``mmw.py:28-33``), via sparse elementwise ops — scalable to 1M rows."""
    S = S_csr.tocsr()
    Q = Q_csr.tocsr()
    ST = S.transpose().tocsr(copy=True)
    Qpat = Q.copy()
    Qpat.data = np.ones_like(Qpat.data)
    St = (ST - ST.multiply(Qpat)).tocsr()
    St.setdiag(0.0)
    St.eliminate_zeros()
    St.sort_indices()
    return St


def ell_from_scipy(S_csr, Q_csr, h_max, pad_rows_to: Optional[int] = None,
                   deg_pad: Optional[int] = None,
                   dtype=np.float32, host: bool = False) -> EllState:
    """Build the ELL state from the reference's CSR ``(S, Q, h_max)`` without
    ever densifying — scalable to millions of links.  ``host=True`` keeps
    the leaves as numpy arrays (see ``ops.bcsr.bcsr_operands_from_state``)
    for callers that shard them straight from the host."""
    import scipy.sparse

    S = S_csr.tocsr()
    Q = Q_csr.tocsr()
    K = S.shape[0]
    Kp = pad_rows_to or _round_up(K, 8)

    diag_S = np.zeros(Kp, dtype)
    diag_S[:K] = S.diagonal()

    St = build_st_csr(S, Q)
    StT = St.transpose().tocsr()
    StT.sort_indices()

    degS = deg_pad or _round_up(
        max(int(np.diff(St.indptr).max(initial=0)),
            int(np.diff(StT.indptr).max(initial=0))), 8)

    def to_ell(M, deg):
        cols = np.zeros((Kp, deg), np.int32)
        vals = np.zeros((Kp, deg), dtype)
        counts = np.diff(M.indptr)
        if counts.max(initial=0) > deg:
            raise ValueError(f"row degree {counts.max()} exceeds pad {deg}")
        row_of = np.repeat(np.arange(M.shape[0]), counts)
        slot_of = np.arange(M.nnz) - np.repeat(M.indptr[:-1], counts)
        cols[row_of, slot_of] = M.indices
        vals[row_of, slot_of] = M.data
        return cols, vals

    s_cols, s_vals = to_ell(St, degS)
    st_cols, st_vals = to_ell(StT, degS)

    # Symmetrization weights: 1 per directed edge, 0.5 where bidirectional
    # (so undirected pattern edges are counted once in X-operator applies).
    P = St.copy()
    P.data = np.ones_like(P.data)
    B = P.multiply(P.transpose()).tocsr()     # bidirectional pattern
    Wm = (P - 0.5 * B).tocsr()
    Wm.sort_indices()
    s_xw = to_ell(Wm, degS)[1]
    WmT = Wm.transpose().tocsr()
    WmT.sort_indices()
    st_xw = to_ell(WmT, degS)[1]

    # Association upper-tri edges + per-row pointers.
    Qu = scipy.sparse.triu(Q, k=1).tocoo()
    E = Qu.nnz
    E_pad = _round_up(E, 8)
    a_i = np.zeros(E_pad, np.int32)
    a_j = np.zeros(E_pad, np.int32)
    a_mask = np.zeros(E_pad, bool)
    a_i[:E], a_j[:E], a_mask[:E] = Qu.row, Qu.col, True

    degQ = _round_up(int(np.diff(Q.indptr).max(initial=0)), 4)
    q_cols = np.zeros((Kp, degQ), np.int32)
    q_eidx = np.zeros((Kp, degQ), np.int32)
    q_mask = np.zeros((Kp, degQ), bool)
    # Both directions of every ut edge, grouped by endpoint, slotted by
    # within-row cumulative count (vectorized; no per-edge Python loop).
    ends = np.concatenate([Qu.row, Qu.col]).astype(np.int64)
    peers = np.concatenate([Qu.col, Qu.row]).astype(np.int64)
    eids = np.concatenate([np.arange(E), np.arange(E)])
    order = np.argsort(ends, kind="stable")
    ends, peers, eids = ends[order], peers[order], eids[order]
    counts = np.bincount(ends, minlength=Kp)
    if counts.max(initial=0) > degQ:
        raise ValueError("association degree exceeds pad")
    starts = np.zeros(Kp + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slots = np.arange(ends.size) - starts[ends]
    q_cols[ends, slots] = peers
    q_eidx[ends, slots] = eids
    q_mask[ends, slots] = True
    q_gain = np.zeros((Kp, degQ), dtype)
    q_gain[ends, slots] = _csr_gather(S, ends, peers).astype(dtype)

    hm = np.zeros(Kp, dtype)
    hm[:K] = np.asarray(h_max, dtype)
    mask = np.zeros(Kp, bool)
    mask[:K] = True

    # Binary-search bounds from the host CSR — identical semantics to the
    # array-based degree_bounds() fallback, without reading device arrays
    # back.  The association pattern mirrors the q_* build exactly: both
    # directions of the upper-triangular edges.
    Qu_pat = scipy.sparse.triu(Q, k=1).tocsr()
    Qb = (Qu_pat + Qu_pat.T).tocsr()
    Qb.data = np.ones_like(Qb.data)
    lb_cache = int(np.diff(Qb.indptr).max(initial=0)) + 1
    Pp = St.copy()                     # St: nonzero off-diag pattern of S̃
    Pp.data = np.ones_like(Pp.data)
    U = (Pp + Pp.T + Qb).tocsr()       # structural union, all off-diagonal
    ub_cache = int(np.diff(U.indptr).max(initial=0)) + 2
    # Caches store the UNCLAMPED reference bounds so asso_lower_bound() agrees
    # between cached and array-fallback states; degree_bounds() applies the
    # Z>=2 clamp (simplex encoding is singular at Z=1) at read time.

    asarray = np.asarray if host else jnp.asarray
    return EllState(
        s_cols=asarray(s_cols), s_vals=asarray(s_vals),
        st_cols=asarray(st_cols), st_vals=asarray(st_vals),
        s_xw=asarray(s_xw), st_xw=asarray(st_xw),
        a_i=asarray(a_i), a_j=asarray(a_j), a_mask=asarray(a_mask),
        q_cols=asarray(q_cols), q_eidx=asarray(q_eidx),
        q_mask=asarray(q_mask), q_gain=asarray(q_gain),
        diag_S=asarray(diag_S), h_max=asarray(hm),
        mask=asarray(mask), K=K, lb_cache=lb_cache, ub_cache=ub_cache)


def ell_from_sig_state(state) -> EllState:
    """Interop from the dense container (testing at small K)."""
    from sig_sdp_mmw_tpu.core.problem import state_to_scipy

    return ell_from_scipy(*state_to_scipy(state))
