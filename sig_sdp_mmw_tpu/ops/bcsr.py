"""Block-ELL sparse matmul — the large-graph SpMM.

The interference graph is *spatially local* (users only hear APs within a
cutoff — :func:`sig_sdp_mmw_tpu.env.large.interference_cutoff_m`), so after
reordering users along a space-filling curve the sparse matrix is banded.
We store it as **block-ELL**: for each row-block, a padded list of nonempty
column blocks, laid out [Kbr, Br, maxblk, Bc] so the slot axis flattens into
the contraction axis for free.  The SpMM is then ONE batched
[Br, maxblk*Bc] x [maxblk*Bc, D] ``dot_general`` per block-row, with gathers
only at whole-block granularity (contiguous).

Blocks are stored dense, zeros included, so the bytes moved per SpMM scale
with the stored blocks, not with nnz.  At K~100k the block fill is ~1.5%;
whether a nnz-proportional format does better is an open, measured question.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _block_pair(block) -> Tuple[int, int]:
    """Normalize a block spec (an int for square blocks, or a pair) to
    (Brow, Bcol)."""
    if isinstance(block, (tuple, list)):
        return int(block[0]), int(block[1])
    return int(block), int(block)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockEll:
    """Block-ELL sparse matrix.  ``blocks`` is stored [Kbr, Brow, maxblk,
    Bcol] — the slot axis INSIDE the row axis — so that flattening
    (maxblk, Bcol) into one contraction axis is a free reshape and the whole
    SpMM is a single batched ``dot_general`` (see :func:`bcsr_spmm`)."""

    bcols: jax.Array    # [Kbr, maxblk] int32 — column-block indices
    blocks: jax.Array   # [Kbr, Brow, maxblk, Bcol] — dense block values
    nrows: int = dataclasses.field(metadata=dict(static=True))

    @property
    def B(self) -> int:           # Bcol (column width of a block)
        return self.blocks.shape[-1]

    @property
    def Brow(self) -> int:
        return self.blocks.shape[1]

    @property
    def Kb(self) -> int:
        return self.bcols.shape[0]


def _bcsr_arrays_np(M, block=128, pad_rows_to: int = None,
                    dtype=np.float32, return_entry_maps: bool = False):
    """Host-side BlockEll arrays (numpy) from a scipy CSR matrix.

    ``block`` may be an int (square) or a (Brow, Bcol) tuple.  With
    ``return_entry_maps`` also returns, per nonzero (in the matrix's COO
    order), its (block-row, slot, local-row, local-col) — the basis for the
    edge-level Gram accumulation maps."""
    Br, Bc = _block_pair(block)
    M = M.tocsr()
    K = M.shape[0]
    lcm = Br * Bc // math.gcd(Br, Bc)
    Kp = pad_rows_to or ((K + lcm - 1) // lcm) * lcm
    Kbr = Kp // Br
    Kbc = Kp // Bc

    coo = M.tocoo()
    br = coo.row.astype(np.int64) // Br
    bc = coo.col.astype(np.int64) // Bc
    blk_id = br * Kbc + bc
    uniq, inv = np.unique(blk_id, return_inverse=True)
    ubr, ubc = uniq // Kbc, uniq % Kbc

    counts = np.bincount(ubr, minlength=Kbr)
    maxblk = max(int(counts.max(initial=0)), 1)

    bcols = np.zeros((Kbr, maxblk), np.int32)
    slot_of_uniq = np.zeros(uniq.size, np.int64)
    starts = np.zeros(Kbr + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    order = np.argsort(ubr, kind="stable")
    slots = np.arange(uniq.size) - starts[ubr[order]]
    slot_of_uniq[order] = slots
    bcols[ubr[order], slots] = ubc[order]

    slot_of_entry = slot_of_uniq[inv]
    rloc = coo.row % Br
    cloc = coo.col % Bc
    # One flat scatter (a 4-array fancy assignment over 20M+ entries costs
    # ~4x more in index arithmetic at million-link scale).
    pos = ((br * Br + rloc) * maxblk + slot_of_entry) * Bc + cloc
    blocks = np.zeros(Kbr * Br * maxblk * Bc, dtype)
    blocks[pos] = coo.data
    blocks = blocks.reshape(Kbr, Br, maxblk, Bc)
    if return_entry_maps:
        return bcols, blocks, Kp, (br, slot_of_entry, rloc, cloc)
    return bcols, blocks, Kp


def bcsr_from_csr(M, block: int = 128, pad_rows_to: int = None,
                  dtype=np.float32) -> BlockEll:
    """Convert a scipy CSR matrix to BlockEll."""
    bcols, blocks, Kp = _bcsr_arrays_np(M, block, pad_rows_to, dtype)
    return BlockEll(bcols=jnp.asarray(bcols), blocks=jnp.asarray(blocks),
                    nrows=Kp)


def bcsr_spmm(mat: BlockEll, V: jax.Array,
              precision=lax.Precision.HIGHEST,
              row_chunk: Optional[int] = None) -> jax.Array:
    """BlockEll [Kp, Kp] x [Kp, D] -> [Kp, D].

    ONE batched ``dot_general``: for each block-row, the maxblk stored
    blocks form one [Br, maxblk*Bc] matrix (free reshape thanks to the
    [Kbr, Br, maxblk, Bc] storage layout) contracted against the gathered
    [maxblk*Bc, D] stack of V column-blocks.

    Blocks may be stored in a narrower dtype (bfloat16) than V; V is cast
    to the block dtype, the product runs in that dtype and accumulates in
    V.dtype (float32) via ``preferred_element_type`` — the memory-lean
    large-graph mode.  Blocks may be rectangular (Brow x Bcol).

    ``row_chunk``: process block-rows in chunks of this size (memory lean:
    the gathered V stack is [row_chunk, maxblk, Bc, D] instead of
    [Kbr, ...]).  None = fully fused.
    """
    Br, Bc = mat.Brow, mat.B
    Kbr = mat.Kb
    Kbc = mat.nrows // Bc
    D = V.shape[1]
    acc_dtype = V.dtype
    Vb = V.astype(mat.blocks.dtype).reshape(Kbc, Bc, D)
    maxblk = mat.bcols.shape[1]

    def rows(blocks, bcols):
        R = Vb[bcols]                                # [kb, maxblk, Bc, D]
        return lax.dot_general(
            blocks, R,
            dimension_numbers=(((2, 3), (1, 2)), ((0,), (0,))),
            precision=precision, preferred_element_type=acc_dtype)

    if row_chunk is None or row_chunk >= Kbr:
        out = rows(mat.blocks, mat.bcols)            # [Kbr, Br, D]
        return out.reshape(Kbr * Br, D)

    nfull = Kbr // row_chunk
    out = jnp.zeros((Kbr, Br, D), acc_dtype)

    def chunk(c, acc):
        i = c * row_chunk
        o = rows(lax.dynamic_slice_in_dim(mat.blocks, i, row_chunk),
                 lax.dynamic_slice_in_dim(mat.bcols, i, row_chunk))
        return lax.dynamic_update_slice_in_dim(acc, o, i, axis=0)

    out = lax.fori_loop(0, nfull, chunk, out)
    rem = Kbr - nfull * row_chunk
    if rem:
        o = rows(mat.blocks[nfull * row_chunk:], mat.bcols[nfull * row_chunk:])
        out = lax.dynamic_update_slice_in_dim(out, o, nfull * row_chunk,
                                              axis=0)
    return out.reshape(Kbr * Br, D)


def bcsr_pair_from_state(S_csr, Q_csr, block: int = 128
                         ) -> Tuple[BlockEll, BlockEll]:
    """(S tilde, S tilde^T) as BlockEll matrices for the MMW Lanczos matvec."""
    from sig_sdp_mmw_tpu.core.ell import build_st_csr

    St = build_st_csr(S_csr, Q_csr)
    K = St.shape[0]
    nr = ((K + block - 1) // block) * block
    StT = St.transpose().tocsr()
    return (bcsr_from_csr(St, block=block, pad_rows_to=nr),
            bcsr_from_csr(StT, block=block, pad_rows_to=nr))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BcsrOperands:
    """Everything the block-native MMW needs (see models/mmw_ell.py):

    * ``s_blocks`` / ``st_blocks`` — S tilde and its transpose as BlockEll.
      ``st_blocks`` may be ``None`` (memory-lean mode): the transpose matvec
      then runs through :func:`bcsr_spmm_transpose` on ``s_blocks``;
    * edge-level Gram machinery (the million-link averaging path): the
      averaged primal X lives as a [nnz+1] per-edge vector, not a block
      array.  ``g_src``/``g_dst`` [maxblk, max_e] map each slot's block-Gram
      output to edge ids (:func:`bcsr_edge_gram_accum`); ``w_edge`` [nnz]
      holds the symmetrization weights (1 one-way / 0.5 bidirectional) in
      the same edge order; ``s_pos`` [nnz] are flat positions into
      [Kbr, Br, maxblk, Bc] for scattering averaged edge values back into a
      block operator at the end;
    * association-edge block layout: ``q_bcols`` plus flat scatter positions
      ``q_pos``/source ids ``q_eidx`` mapping the [E_pad] upper-tri edge
      value vector into a [Kbr, Br, maxblkQ, Bc] block array (both
      directions).
    """

    s_blocks: BlockEll
    st_blocks: Optional[BlockEll]
    g_src: jax.Array     # [maxblk, max_e] int32
    g_dst: jax.Array     # [maxblk, max_e] int32 (nnz = sink)
    w_edge: jax.Array    # [nnz] f32 or weights_dtype (values exactly 1.0/0.5)
    s_pos: jax.Array     # [nnz] int32
    q_bcols: jax.Array   # [Kbr, maxblkQ] int32
    q_pos: jax.Array     # [2E] int32 flat positions into the q block array
    q_eidx: jax.Array    # [2E] int32 indices into the ut edge value vector

    @property
    def nnz(self) -> int:
        return self.w_edge.shape[0]


# Above this nnz the operand build routes through the C++ packer (bit-
# identical — tests/test_native.py); below it the numpy path keeps CI
# coverage of both implementations.
_NATIVE_PACK_MIN_NNZ = 1 << 20


def bcsr_operands_from_state(S_csr, Q_csr, E_pad: int = None,
                             block=(8, 128), dtype=np.float32,
                             store_transpose: bool = False,
                             weights_dtype=np.float32,
                             pad_rows_to: Optional[int] = None,
                             host: bool = False) -> BcsrOperands:
    """``block``: (Brow, Bcol) or int; smaller blocks raise the block fill
    but shorten each contraction.  The default (8, 128) is kept until an
    in-loop format comparison on the GPU picks one.  ``dtype``: storage
    dtype of the value blocks — ``np.float32`` exact, or ``jnp.bfloat16``
    for half the footprint (the SpMM still accumulates in f32; ~0.4%
    per-entry value noise, well inside MMW's first-order convergence
    tolerance — validated in tests/test_ell.py).
    ``store_transpose=False`` (default) runs S̃ᵀ matvecs as scatter-adds
    through ``s_blocks`` instead of storing a transposed copy.
    ``weights_dtype``: storage dtype of the [nnz] symmetrization weight
    vector ``w_edge`` — its values are exactly 1.0 or 0.5, so bfloat16
    storage is lossless and halves another O(nnz) buffer; the consumer
    (models/mmw_ell.py) casts back to f32 at use.

    Every leaf is built on the host (value casts included, so no f32 block
    transient reaches the device) and returned uncommitted on the default
    device; callers that need a specific device place the operands with
    ``jax.device_put``.  ``host=True`` returns the leaves as numpy arrays
    instead, so that a caller sharding them over a mesh sends each device
    only its own slice and no device ever holds the whole set.
    """
    import scipy.sparse
    from sig_sdp_mmw_tpu.core.ell import build_st_csr

    Br, Bc = _block_pair(block)
    St = build_st_csr(S_csr, Q_csr)
    St.sort_indices()
    K = St.shape[0]
    lcm = Br * Bc // math.gcd(Br, Bc)
    nr = ((K + lcm - 1) // lcm) * lcm
    if pad_rows_to is not None:
        if pad_rows_to < nr or pad_rows_to % lcm:
            raise ValueError(f"pad_rows_to must be a multiple of {lcm} "
                             f">= {nr}, got {pad_rows_to}")
        nr = pad_rows_to
    Kbr = nr // Br
    Kbc = nr // Bc
    # Large instances route through the C++ OpenMP packer (csrc
    # sig_bcsr_pack): the value cast is fused into the scatter, so a bf16
    # operand never materializes the f32 block array (3+ GB at 1M links) and
    # the pack itself parallelizes over block-rows.  Bit-identical to the
    # numpy path (tests/test_native.py); small instances keep the numpy path
    # so CI exercises both.
    from sig_sdp_mmw_tpu.native.builder import (bcsr_pack_native,
                                                native_available)
    s_native = None
    if St.nnz > _NATIVE_PACK_MIN_NNZ and native_available():
        s_native = bcsr_pack_native(St, (Br, Bc), pad_rows_to=nr,
                                    dtype=dtype, return_entry_maps=True)
    if s_native is not None:
        s_bcols, s_vals_np, _, (ebr, eslot, erloc, ecloc, epos) = s_native
    else:
        s_bcols, s_vals_np, _, (ebr, eslot, erloc, ecloc) = _bcsr_arrays_np(
            St, (Br, Bc), pad_rows_to=nr, dtype=np.float32,
            return_entry_maps=True)
        epos = None
    maxblk = s_bcols.shape[1]
    nnz = St.nnz

    # --- edge-level Gram maps (entry order = St COO order = CSR sorted) ---
    if s_native is not None:
        # Counting-sort grouping in C++ — no 25M-entry argsort; s_pos comes
        # straight from the packer's scatter positions.
        from sig_sdp_mmw_tpu.native.builder import bcsr_gram_maps_native
        g_src, g_dst = bcsr_gram_maps_native(ebr, eslot, erloc, ecloc,
                                             maxblk, Br, Bc)
        s_pos = epos
    else:
        # Position of entry e inside slot s's [Kbr, Br, Bc] Gram output:
        src_pos = ((ebr * Br + erloc) * Bc + ecloc).astype(np.int64)
        counts_s = np.bincount(eslot, minlength=maxblk)
        max_e = max(int(counts_s.max(initial=0)), 1)
        g_src = np.zeros((maxblk, max_e), np.int32)
        g_dst = np.full((maxblk, max_e), nnz, np.int32)  # sink by default
        order = np.argsort(eslot, kind="stable")
        within = np.arange(nnz) - np.concatenate(
            ([0], np.cumsum(counts_s)))[eslot[order]]
        g_src[eslot[order], within] = src_pos[order]
        g_dst[eslot[order], within] = np.arange(nnz)[order]

        # Position of entry e in the full [Kbr, Br, maxblk, Bc] block array
        # (for scattering averaged edge values back into an operator):
        s_pos = (((ebr * Br + erloc) * maxblk + eslot) * Bc
                 + ecloc).astype(np.int32)

    # Symmetrization weights, aligned with St's CSR entry order.
    if s_native is not None:
        # Entrywise transpose-membership test in C++ — no scipy
        # multiply/subtract passes; values identical (exactly 1.0 / 0.5)
        # and CSR-entry-order by construction.
        from sig_sdp_mmw_tpu.native.builder import bcsr_sym_weights_native
        w_edge = bcsr_sym_weights_native(St)
    else:
        P = St.copy()
        P.data = np.ones_like(P.data)
        B2 = P.multiply(P.transpose()).tocsr()
        Wm = (P - 0.5 * B2).tocsr()
        Wm.sort_indices()
        # Host-side consistency check before any device transfer.
        if not (np.array_equal(Wm.indices, St.indices)
                and np.array_equal(Wm.indptr, St.indptr)):
            raise AssertionError("weight/value edge orders diverged")
        w_edge = Wm.data.astype(np.float32)

    asarray = np.asarray if host else jnp.asarray

    def _cast(arr, dt):
        return asarray(arr.astype(np.dtype(dt), copy=False))

    s_blocks = BlockEll(bcols=asarray(s_bcols),
                        blocks=_cast(s_vals_np, dtype), nrows=nr)
    st_blocks = None
    if store_transpose:
        StT = St.transpose().tocsr()
        if s_native is not None:
            st_bcols, st_vals_np, _ = bcsr_pack_native(
                StT, (Br, Bc), pad_rows_to=nr, dtype=dtype)
        else:
            st_bcols, st_vals_np, _ = _bcsr_arrays_np(
                StT, (Br, Bc), pad_rows_to=nr, dtype=np.float32)
        st_blocks = BlockEll(bcols=asarray(st_bcols),
                             blocks=_cast(st_vals_np, dtype), nrows=nr)

    # Association edges -> block scatter layout.
    Qu = scipy.sparse.triu(Q_csr.tocsr(), k=1).tocoo()
    E = Qu.nnz
    ii = np.concatenate([Qu.row, Qu.col]).astype(np.int64)
    jj = np.concatenate([Qu.col, Qu.row]).astype(np.int64)
    ee = np.concatenate([np.arange(E), np.arange(E)]).astype(np.int64)

    bi, bj = ii // Br, jj // Bc
    blk_id = bi * Kbc + bj
    uniq = np.unique(blk_id)
    ubr, ubc = uniq // Kbc, uniq % Kbc
    counts = np.bincount(ubr, minlength=Kbr)
    maxblkQ = max(int(counts.max(initial=0)), 1)
    q_bcols = np.zeros((Kbr, maxblkQ), np.int32)
    starts = np.zeros(Kbr + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    order = np.argsort(ubr, kind="stable")
    slots_of_uniq = np.empty(uniq.size, np.int64)
    slots_of_uniq[order] = np.arange(uniq.size) - starts[ubr[order]]
    q_bcols[ubr, slots_of_uniq] = ubc

    slot_of_edge = slots_of_uniq[np.searchsorted(uniq, blk_id)]
    # Flat position in the [Kbr, Br, maxblkQ, Bc] association block array.
    q_pos = (((bi * Br + ii % Br) * maxblkQ + slot_of_edge) * Bc
             + jj % Bc).astype(np.int32)

    return BcsrOperands(
        s_blocks=s_blocks, st_blocks=st_blocks,
        g_src=asarray(g_src), g_dst=asarray(g_dst),
        w_edge=_cast(w_edge, weights_dtype), s_pos=asarray(s_pos),
        q_bcols=asarray(q_bcols), q_pos=asarray(q_pos),
        q_eidx=asarray(ee.astype(np.int32)))


def bcsr_block_gram(bcols: jax.Array, Xb: jax.Array,
                    precision=lax.Precision.HIGHEST) -> jax.Array:
    """Pattern-restricted block Gram: for every (block-row k, slot s),
    ``Xb[k] @ Xb[bcols[k, s]]^T`` -> [Kb, maxblk, B, B].  The batched-matmul
    replacement for per-edge gather dots.  (Square-block layout only.)"""
    maxblk = bcols.shape[1]

    def slot(s, acc):
        G = lax.dot_general(Xb, Xb[bcols[:, s]],
                            dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                            precision=precision)
        return acc.at[:, s].set(G)

    Kb, B, _ = Xb.shape
    return lax.fori_loop(0, maxblk, slot,
                         jnp.zeros((Kb, maxblk, B, B), Xb.dtype))


def bcsr_edge_gram_accum(bcols: jax.Array, Xr: jax.Array, Xc: jax.Array,
                         g_src: jax.Array, g_dst: jax.Array,
                         acc: jax.Array, scale,
                         precision=lax.Precision.HIGHEST) -> jax.Array:
    """Accumulate the PATTERN-RESTRICTED Gram onto a per-edge vector:
    ``acc[e] += scale * <X[i_e], X[j_e]>`` for every nonzero e of the block
    pattern, slot by slot.  Per slot: one batched [Br, D] x [Bc, D]^T
    matmul produces the block Gram ([Kbr, Br, Bc], a small transient), whose
    actual-nonzero entries are gathered by ``g_src[s]`` and scatter-added at
    ``g_dst[s]`` (padding rows target the sink slot acc[-1]).

    This replaces a full [Kbr, maxblk, Br, Bc] averaged-Gram buffer (4-8 GB
    at million-link scale) with an O(nnz) vector (~85 MB at 21M nonzeros).

    Args:
      Xr: [Kbr, Br, D] row-blocked X;  Xc: [Kbc, Bc, D] column-blocked X
        (same underlying array, different reshape).
      g_src/g_dst: [maxblk, max_e] int32 maps from
        :func:`bcsr_operands_from_state`.
      acc: [nnz_pad + 1] accumulator (last element = padding sink).
    """
    maxblk = bcols.shape[1]

    def slot(s, a):
        G = lax.dot_general(Xr, Xc[bcols[:, s]],
                            dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                            precision=precision,
                            preferred_element_type=a.dtype)
        vals = G.reshape(-1)[g_src[s]]
        return a.at[g_dst[s]].add(scale * vals)

    return lax.fori_loop(0, maxblk, slot, acc)


def bcsr_block_gram_accum(bcols: jax.Array, Xb: jax.Array, acc: jax.Array,
                          scale, precision=lax.Precision.HIGHEST) -> jax.Array:
    """``acc[k, s] += scale * Xb[k] @ Xb[bcols[k, s]]^T`` slot-by-slot,
    updating the accumulator in place.  (Square-block layout; superseded by
    :func:`bcsr_edge_gram_accum` for large graphs.)"""
    maxblk = bcols.shape[1]

    def slot(s, a):
        G = lax.dot_general(Xb, Xb[bcols[:, s]],
                            dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                            precision=precision,
                            preferred_element_type=a.dtype)
        return a.at[:, s].add(scale * G)

    return lax.fori_loop(0, maxblk, slot, acc)


def bcsr_spmm_transpose(mat_bcols: jax.Array, blocks: jax.Array,
                        V: jax.Array,
                        precision=lax.Precision.HIGHEST,
                        row_chunk: Optional[int] = None) -> jax.Array:
    """``A^T @ V`` where A is given in BlockEll form (bcols, blocks):
    all per-(row, slot) contributions ``blocks[k, :, s, :]^T @ Vr[k]`` from
    ONE batched ``dot_general``, scatter-added into the output column
    blocks.  ``row_chunk`` bounds the [*, maxblk, Bc, D] contribution
    transient at large K (None = fully fused)."""
    Kbr, maxblk = mat_bcols.shape
    Br, Bc = blocks.shape[1], blocks.shape[-1]
    nrows = Kbr * Br
    Kbc = nrows // Bc
    D = V.shape[1]
    acc_dtype = V.dtype
    Vr = V.astype(blocks.dtype).reshape(Kbr, Br, D)

    def contribs(blk, v):
        # [kb, Br, maxblk, Bc] x [kb, Br, D] -> [kb, maxblk, Bc, D]
        return lax.dot_general(
            blk, v, dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            precision=precision, preferred_element_type=acc_dtype)

    seg0 = jnp.zeros((Kbc, Bc, D), acc_dtype)
    if row_chunk is None or row_chunk >= Kbr:
        c = contribs(blocks, Vr).reshape(Kbr * maxblk, Bc, D)
        seg = seg0.at[mat_bcols.reshape(-1)].add(c)
        return seg.reshape(nrows, D)

    nfull = Kbr // row_chunk

    def chunk(ci, acc):
        i = ci * row_chunk
        c = contribs(lax.dynamic_slice_in_dim(blocks, i, row_chunk),
                     lax.dynamic_slice_in_dim(Vr, i, row_chunk))
        ids = lax.dynamic_slice_in_dim(mat_bcols, i, row_chunk)
        return acc.at[ids.reshape(-1)].add(
            c.reshape(row_chunk * maxblk, Bc, D))

    seg = lax.fori_loop(0, nfull, chunk, seg0)
    rem = Kbr - nfull * row_chunk
    if rem:
        c = contribs(blocks[nfull * row_chunk:], Vr[nfull * row_chunk:])
        seg = seg.at[mat_bcols[nfull * row_chunk:].reshape(-1)].add(
            c.reshape(rem * maxblk, Bc, D))
    return seg.reshape(nrows, D)


def spatial_order(sta_locs: np.ndarray, cell_edge: float) -> np.ndarray:
    """Permutation sorting users by grid cell (row-major), making the
    interference graph banded for block-sparse storage.  Superseded by
    :func:`hilbert_order` (raster adjacency is 1-D only: neighbors in the
    next grid row are a full row of users away in index space, so each
    row-block touches ~2x the column blocks the 2-D-local Hilbert order
    needs — measured fill 3.08% vs 5.4% at K=100k and 1M)."""
    cx = np.floor(sta_locs[:, 0] / cell_edge).astype(np.int64)
    cy = np.floor(sta_locs[:, 1] / cell_edge).astype(np.int64)
    ncx = int(cx.max(initial=0)) + 1
    return np.argsort(cy * ncx + cx, kind="stable")


def hilbert_order(sta_locs: np.ndarray, order: int = 16) -> np.ndarray:
    """Permutation sorting users along a Hilbert space-filling curve.

    Spatially close users get close indices in BOTH coordinates (unlike the
    raster order, which is only local along x), so an interference
    neighborhood — a disc of radius
    :func:`sig_sdp_mmw_tpu.env.large.interference_cutoff_m` — maps to a
    short index interval.  Effect on the block-ELL storage
    (:class:`BlockEll`): 1.75x higher block fill (3.08% -> 5.4% measured at
    K=100k and K=1M) = 1.75x fewer streamed bytes per SpMM, and a smaller
    slot count (maxblk 10 -> 8).  A pure relabeling — solution-invariant.

    Vectorized d-index computation (the classic xy2d bit-interleave walk,
    one pass over ``order`` bit planes for all K points at once).
    """
    n = 1 << order
    xy = np.asarray(sta_locs, np.float64)
    ext = float((xy.max(axis=0) - xy.min(axis=0)).max())
    q = ((xy - xy.min(axis=0)) / max(ext, 1e-9) * (n - 1)).astype(np.int64)
    x, y = q[:, 0].copy(), q[:, 1].copy()
    d = np.zeros(x.shape[0], np.int64)
    s = n // 2
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        flip = ry == 0
        xr = np.where(flip & (rx == 1), n - 1 - x, x)
        yr = np.where(flip & (rx == 1), n - 1 - y, y)
        x, y = np.where(flip, yr, xr), np.where(flip, xr, yr)
        s //= 2
    return np.argsort(d, kind="stable")
