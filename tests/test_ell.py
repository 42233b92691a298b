"""ELL sparse backend: kernels vs dense oracles, sparse MMW vs dense MMW."""

import functools
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sig_sdp_mmw_tpu.core.ell import ell_from_sig_state
from sig_sdp_mmw_tpu.core.problem import state_from_arrays
from sig_sdp_mmw_tpu.models.mmw import mmw_solve
from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell
from sig_sdp_mmw_tpu.models.rounding import rounding, verify_assignment
from sig_sdp_mmw_tpu.ops.ell import ell_spmm


@pytest.fixture(scope="module")
def fix():
    return dict(np.load(pathlib.Path(__file__).parent / "fixtures" / "mmw_small.npz"))


@pytest.fixture(scope="module")
def dense_state(fix):
    return state_from_arrays(fix["S"], fix["Q"], fix["h_max"], dtype=jnp.float32)


@pytest.fixture(scope="module")
def ell_state(dense_state):
    return ell_from_sig_state(dense_state)


def test_ell_structure(dense_state, ell_state):
    K = dense_state.K
    S = np.asarray(dense_state.S, dtype=np.float64)[:K, :K]
    Q = np.asarray(dense_state.Q)[:K, :K]
    # Rebuild dense S tilde from the ELL arrays and compare.
    St_want = S.T.copy()
    St_want[Q != 0] = 0.0
    np.fill_diagonal(St_want, 0.0)
    Kp = ell_state.Kp
    St_got = np.zeros((Kp, Kp))
    cols = np.asarray(ell_state.s_cols)
    vals = np.asarray(ell_state.s_vals)
    for k in range(Kp):
        for d in range(cols.shape[1]):
            if vals[k, d] != 0:
                St_got[k, cols[k, d]] += vals[k, d]
    np.testing.assert_allclose(St_got[:K, :K], St_want, rtol=1e-6)

    # Symmetrization weights cover each undirected edge exactly once.
    W = (np.asarray(ell_state.s_xw) > 0) * np.asarray(ell_state.s_xw)
    cover = np.zeros((Kp, Kp))
    for k in range(Kp):
        for d in range(cols.shape[1]):
            if W[k, d] != 0:
                cover[k, cols[k, d]] += W[k, d]
    colsT = np.asarray(ell_state.st_cols)
    WT = np.asarray(ell_state.st_xw)
    for k in range(Kp):
        for d in range(colsT.shape[1]):
            if WT[k, d] != 0:
                cover[k, colsT[k, d]] += WT[k, d]
    pat = ((St_got != 0) | (St_got.T != 0)).astype(float)
    np.testing.assert_allclose(cover, pat, atol=1e-7)


def test_ell_spmm_matches_dense(ell_state, dense_state):
    Kp = ell_state.Kp
    rng = np.random.default_rng(0)
    V = jnp.asarray(rng.standard_normal((Kp, 8)).astype(np.float32))
    got = ell_spmm(ell_state.s_cols, ell_state.s_vals, V)

    K = dense_state.K
    S = np.asarray(dense_state.S, dtype=np.float64)[:K, :K]
    Q = np.asarray(dense_state.Q)[:K, :K]
    St = S.T.copy()
    St[Q != 0] = 0.0
    np.fill_diagonal(St, 0.0)
    want = St @ np.asarray(V, dtype=np.float64)[:K]
    np.testing.assert_allclose(np.asarray(got)[:K], want, rtol=1e-4,
                               atol=1e-5)


def test_sparse_mmw_matches_dense(dense_state, ell_state, fix):
    """Same key => same sketches => the two backends must track each other."""
    Z = float(fix["Z_fin"])
    key = jax.random.PRNGKey(0)
    dense = jax.jit(lambda s, k: mmw_solve(s, Z, nit=60, eta=0.05, D_pad=32,
                                           rank_pad=32, key=k))(dense_state, key)
    sparse = jax.jit(lambda s, k: mmw_solve_ell(s, Z, nit=60, eta=0.05,
                                                D_pad=32, rank_pad=32, key=k)
                     )(ell_state, key)

    # The iteration trajectories are IDENTICAL (same PRNG stream, same math
    # on different representations) — the averaged-X max violation must agree
    # to float tolerance.
    assert float(sparse.ub_final) == pytest.approx(float(dense.ub_final),
                                                   abs=1e-4)
    # The final factors come from different randomized factorizations of the
    # same averaged X (truncation of a slowly-decaying tail), so compare the
    # Gram matrices loosely.
    Gd = np.asarray(dense.X_half) @ np.asarray(dense.X_half).T
    Gs = np.asarray(sparse.X_half) @ np.asarray(sparse.X_half).T
    assert np.abs(Gs - Gd).max() < 0.25 * np.abs(Gd).max()
    assert np.corrcoef(Gs.ravel(), Gd.ravel())[0, 1] > 0.95


def test_bcsr_spmm_matches_ell(dense_state, ell_state):
    import scipy.sparse
    from sig_sdp_mmw_tpu.core.problem import state_to_scipy
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_pair_from_state, bcsr_spmm

    S, Q, h = state_to_scipy(dense_state)
    s_b, st_b = bcsr_pair_from_state(S, Q, block=16)
    Kp = ell_state.Kp
    rng = np.random.default_rng(3)
    V = jnp.asarray(rng.standard_normal((Kp, 8)).astype(np.float32))
    want = ell_spmm(ell_state.s_cols, ell_state.s_vals, V)
    nr = s_b.nrows
    Vp = jnp.pad(V, ((0, nr - Kp), (0, 0))) if nr > Kp else V
    got = bcsr_spmm(s_b, Vp)[:Kp]
    np.testing.assert_allclose(np.asarray(got)[: dense_state.K],
                               np.asarray(want)[: dense_state.K],
                               rtol=1e-4, atol=1e-5)

    wantT = ell_spmm(ell_state.st_cols, ell_state.st_vals, V)
    gotT = bcsr_spmm(st_b, Vp)[:Kp]
    np.testing.assert_allclose(np.asarray(gotT)[: dense_state.K],
                               np.asarray(wantT)[: dense_state.K],
                               rtol=1e-4, atol=1e-5)


def test_sparse_mmw_bcsr_path_matches_ell_path(ell_state, dense_state, fix):
    from sig_sdp_mmw_tpu.core.problem import state_to_scipy
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    S, Q, h = state_to_scipy(dense_state)
    ops = bcsr_operands_from_state(S, Q, block=16)
    Z = float(fix["Z_fin"])
    key = jax.random.PRNGKey(0)
    a = jax.jit(lambda e, k: mmw_solve_ell(e, Z, nit=20, eta=0.05, D_pad=32,
                                           rank_pad=32, key=k))(ell_state, key)
    b = jax.jit(lambda e, k: mmw_solve_ell(e, Z, nit=20, eta=0.05, D_pad=32,
                                           rank_pad=32, key=k, bcsr=ops)
                )(ell_state, key)
    # Identical math on different layouts: trajectories must agree tightly.
    assert float(b.ub_final) == pytest.approx(float(a.ub_final), abs=1e-4)
    # Final factors use the same rsvd keys and the same averaged operator.
    Ga = np.asarray(a.X_half) @ np.asarray(a.X_half).T
    Gb = np.asarray(b.X_half) @ np.asarray(b.X_half).T
    np.testing.assert_allclose(Gb, Ga, atol=2e-3 * max(np.abs(Ga).max(), 1e-9))


def test_sparse_mmw_bcsr_memory_lean_modes(ell_state, dense_state, fix):
    """The million-link storage modes — narrower block size, bfloat16 block
    values (f32 accumulation), and no stored transpose (segment-sum
    scatter matvec) — must reproduce the reference-layout trajectory."""
    from sig_sdp_mmw_tpu.core.problem import state_to_scipy
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    S, Q, h = state_to_scipy(dense_state)
    Z = float(fix["Z_fin"])
    key = jax.random.PRNGKey(0)
    ref = jax.jit(lambda e, k: mmw_solve_ell(e, Z, nit=20, eta=0.05, D_pad=32,
                                             rank_pad=32, key=k))(ell_state,
                                                                  key)
    Gr = np.asarray(ref.X_half) @ np.asarray(ref.X_half).T
    for kw, tol in [
        (dict(block=16, store_transpose=False), 1e-4),
        (dict(block=8, dtype=jnp.bfloat16, store_transpose=False,
              weights_dtype=jnp.bfloat16), 2e-2),
    ]:
        ops = bcsr_operands_from_state(S, Q, **kw)
        out = jax.jit(lambda e, k, b: mmw_solve_ell(
            e, Z, nit=20, eta=0.05, D_pad=32, rank_pad=32, key=k, bcsr=b)
        )(ell_state, key, ops)
        assert float(out.ub_final) == pytest.approx(float(ref.ub_final),
                                                    abs=tol)
        G = np.asarray(out.X_half) @ np.asarray(out.X_half).T
        assert np.abs(G - Gr).max() < max(tol, 5e-3) * max(np.abs(Gr).max(), 1e-9)


def test_sparse_mmw_slim_state_and_row_chunk(ell_state, dense_state, fix):
    """EllSlim (no O(K*deg) device arrays) and chunked fused SpMM must
    reproduce the full-state fused trajectory; slim is the million-link
    argument-memory mode."""
    from sig_sdp_mmw_tpu.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_tpu.core.problem import state_to_scipy
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    S, Q, h = state_to_scipy(dense_state)
    ops = bcsr_operands_from_state(S, Q, block=16)
    Z = float(fix["Z_fin"])
    key = jax.random.PRNGKey(0)
    ref = jax.jit(lambda e, k, b: mmw_solve_ell(
        e, Z, nit=20, eta=0.05, D_pad=32, rank_pad=32, key=k, bcsr=b)
    )(ell_state, key, ops)

    slim = ell_slim_from_csr(S, Q, h, pad_rows_to=ell_state.Kp)
    assert slim.Kp == ell_state.Kp and slim.E_pad == ell_state.E_pad
    for chunk in (None, 7):
        out = jax.jit(lambda e, k, b: mmw_solve_ell(
            e, Z, nit=20, eta=0.05, D_pad=32, rank_pad=32, key=k, bcsr=b,
            spmm_row_chunk=chunk))(slim, key, ops)
        assert float(out.ub_final) == pytest.approx(float(ref.ub_final),
                                                    abs=1e-5)
        G = np.asarray(out.X_half) @ np.asarray(out.X_half).T
        Gr = np.asarray(ref.X_half) @ np.asarray(ref.X_half).T
        np.testing.assert_allclose(G, Gr,
                                   atol=1e-4 * max(np.abs(Gr).max(), 1e-9))

    # EllSlim without a BCSR backend must be rejected.
    with pytest.raises(ValueError):
        mmw_solve_ell(slim, Z, nit=2, eta=0.05, D_pad=32, rank_pad=32,
                      key=key)


def test_mmw_ell_ub_from_carry_matches_ub_final(ell_state, dense_state, fix):
    """The segment-boundary UB telemetry must equal the solver's own
    ub_final when read at n = nit."""
    from sig_sdp_mmw_tpu.core.problem import state_to_scipy
    from sig_sdp_mmw_tpu.models.mmw_ell import mmw_ell_ub_from_carry
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    S, Q, h = state_to_scipy(dense_state)
    ops = bcsr_operands_from_state(S, Q, block=16)
    Z = float(fix["Z_fin"])
    key = jax.random.PRNGKey(0)
    NIT = 15
    kw = dict(nit=NIT, eta=0.05, D_pad=32, rank_pad=32, bcsr=ops)
    out = jax.jit(lambda e, k: mmw_solve_ell(e, Z, key=k, **kw)
                  )(ell_state, key)
    c = jax.jit(lambda e, k: mmw_solve_ell(e, Z, key=k, return_carry=True,
                                           **kw))(ell_state, key)
    ub = float(jax.jit(lambda e, cc: mmw_ell_ub_from_carry(e, Z, cc, NIT)
                       )(ell_state, c))
    assert ub == pytest.approx(float(out.ub_final), abs=1e-6)


def test_sparse_mmw_gram_modes_agree(ell_state, dense_state, fix):
    """'block' (dot_general accumulator, the 100k fast path) and 'edge'
    (per-edge vector, the 1M memory path) averaged-Gram modes must produce
    the same answer — identical iteration trajectory, same final operator
    up to float summation order."""
    from sig_sdp_mmw_tpu.core.problem import state_to_scipy
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    S, Q, h = state_to_scipy(dense_state)
    ops = bcsr_operands_from_state(S, Q, block=16)
    Z = float(fix["Z_fin"])
    key = jax.random.PRNGKey(0)
    outs = {}
    for mode in ("block", "edge"):
        outs[mode] = jax.jit(lambda e, k, b: mmw_solve_ell(
            e, Z, nit=20, eta=0.05, D_pad=32, rank_pad=32, key=k, bcsr=b,
            gram_mode=mode))(ell_state, key, ops)
    assert float(outs["block"].ub_final) == pytest.approx(
        float(outs["edge"].ub_final), abs=1e-7)
    Gb = np.asarray(outs["block"].X_half) @ np.asarray(outs["block"].X_half).T
    Ge = np.asarray(outs["edge"].X_half) @ np.asarray(outs["edge"].X_half).T
    np.testing.assert_allclose(Gb, Ge, atol=1e-5 * max(np.abs(Ge).max(), 1e-9))


def test_sparse_mmw_segmented_matches_single_shot(ell_state, dense_state,
                                                  fix):
    """Segmented execution (carry passed across several device programs)
    must be bit-identical to the single-shot solve — absolute iteration
    indices keep the PRNG streams aligned."""
    from sig_sdp_mmw_tpu.core.problem import state_to_scipy
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    S, Q, h = state_to_scipy(dense_state)
    ops = bcsr_operands_from_state(S, Q, block=16)
    Z = float(fix["Z_fin"])
    key = jax.random.PRNGKey(0)
    NIT = 21
    kw = dict(nit=NIT, eta=0.05, D_pad=32, rank_pad=32, bcsr=ops)
    ref = jax.jit(lambda e, k: mmw_solve_ell(e, Z, key=k, **kw)
                  )(ell_state, key)

    # num_steps is static (trip count); it_start is traced — one executable
    # serves every same-length segment.
    seg7 = jax.jit(functools.partial(
        lambda e, k, c, i0, **kk: mmw_solve_ell(
            e, Z, key=k, carry_in=c, it_start=i0, num_steps=7,
            return_carry=True, **kk), **kw))
    fin = jax.jit(lambda e, k, c: mmw_solve_ell(
        e, Z, key=k, carry_in=c, it_start=NIT, num_steps=0, **kw))
    c = seg7(ell_state, key, None, 0)
    for i0 in (7, 14):
        c = seg7(ell_state, key, c, i0)
    out = fin(ell_state, key, c)
    assert float(out.ub_final) == pytest.approx(float(ref.ub_final),
                                                abs=1e-7)
    np.testing.assert_allclose(np.asarray(out.X_half),
                               np.asarray(ref.X_half), atol=1e-6)


def test_sparse_mmw_rounding_feasible(dense_state, ell_state, fix):
    Z = int(fix["Z_fin"])
    out = jax.jit(lambda s, k: mmw_solve_ell(s, float(Z), nit=150, eta=0.05,
                                             D_pad=32, rank_pad=32, key=k)
                  )(ell_state, jax.random.PRNGKey(1))
    z_vec, _, rem = rounding(Z, out.X_half, dense_state, jax.random.PRNGKey(2))
    assert rem == 0
    ok, ni, na = verify_assignment(dense_state, z_vec)
    assert ok, (ni, na)

