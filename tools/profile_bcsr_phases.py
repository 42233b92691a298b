"""Per-phase microbenchmark of the block-native MMW iteration at large K.

Times each component of the mmw_solve_ell bcsr iteration in isolation on the
accelerator, so optimization targets the actual traffic hogs rather than the
nominal FLOP count.  (The solver's per-iteration wall time is NOT the sum of
these — XLA fuses across phases — but the ranking is what matters.)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools

import numpy as np

print = functools.partial(print, flush=True)


def timeit(fn, *args, n=5):
    """Median ms of float(sum(fn(*args))) — the scalar pull is the
    completion barrier."""
    import jax
    import jax.numpy as jnp

    g = jax.jit(lambda *a: jnp.sum(fn(*a)))
    float(g(*args))
    float(g(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        float(g(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main(cell=183, block=128, bf16=False, no_transpose=False, m=8,
         D_pad=48):
    import jax
    import jax.numpy as jnp

    from sig_sdp_mmw_tpu.core.ell import ell_from_scipy
    from sig_sdp_mmw_tpu.env.large import generate_large_state_csr
    from sig_sdp_mmw_tpu.ops import bcsr as B
    from sig_sdp_mmw_tpu.ops.expm import lanczos_expm_multiply

    S, Q, h = generate_large_state_csr(cell, seed=0)
    K = S.shape[0]
    ell = ell_from_scipy(S, Q, h)
    bops = B.bcsr_operands_from_state(
        S, Q, block=block, dtype=jnp.bfloat16 if bf16 else np.float32,
        store_transpose=not no_transpose)
    Kp = ell.Kp
    nrows = bops.s_blocks.nrows
    Kb = bops.s_blocks.Kb
    Bsz = bops.s_blocks.B
    maxblkQ = bops.q_bcols.shape[1]
    print(f"K={K} Kp={Kp} nrows={nrows} Kb={Kb} B={Bsz} "
          f"maxblk={bops.s_blocks.bcols.shape[1]} maxblkQ={maxblkQ} "
          f"E_pad={ell.E_pad} D={D_pad}")

    key = jax.random.PRNGKey(0)
    V = jax.device_put(np.random.default_rng(0)
                       .standard_normal((nrows, D_pad)).astype(np.float32))
    ev = jax.device_put(np.random.default_rng(1)
                        .standard_normal(ell.E_pad).astype(np.float32))
    bops = jax.device_put(bops)
    a_i, a_j = jax.device_put(np.asarray(ell.a_i)), jax.device_put(np.asarray(ell.a_j))
    acc0 = jnp.zeros((Kb, bops.s_blocks.bcols.shape[1], Bsz, Bsz), jnp.float32)
    acc0 = jax.device_put(acc0)

    t = timeit(lambda b, v: B.bcsr_spmm(b, v), bops.s_blocks, V)
    print(f"s_matvec (bcsr_spmm):           {t:8.2f} ms")

    if bops.st_blocks is not None:
        t = timeit(lambda b, v: B.bcsr_spmm(b, v), bops.st_blocks, V)
        print(f"st_matvec (stored transpose):   {t:8.2f} ms")
    t = timeit(lambda bc, bl, v: B.bcsr_spmm_transpose(bc, bl, v),
               bops.s_blocks.bcols, bops.s_blocks.blocks, V)
    print(f"st_matvec (scatter-add):        {t:8.2f} ms")

    def qvals_fn(ops, e):
        flat = jnp.zeros((Kb * maxblkQ * Bsz * Bsz,), jnp.float32)
        return flat.at[ops.q_pos].set(e[ops.q_eidx]).reshape(
            Kb, Bsz, maxblkQ, Bsz)

    t = timeit(qvals_fn, bops, ev)
    print(f"q_block_vals (scatter):         {t:8.2f} ms")

    qv = jax.jit(qvals_fn)(bops, ev)
    t = timeit(lambda bc, bl, v: B.bcsr_spmm(
        B.BlockEll(bcols=bc, blocks=bl, nrows=nrows), v),
        bops.q_bcols, qv, V)
    print(f"q_matvec:                       {t:8.2f} ms")

    Xb = V.reshape(Kb, Bsz, D_pad)
    t = timeit(lambda bc, xb, a: B.bcsr_block_gram_accum(bc, xb, a, 0.5),
               bops.s_blocks.bcols, Xb, acc0)
    print(f"block_gram_accum:               {t:8.2f} ms")

    eacc0 = jax.device_put(jnp.zeros((bops.nnz + 1,), jnp.float32))
    t = timeit(lambda bc, xr, xc, a: B.bcsr_edge_gram_accum(
        bc, xr, xc, bops.g_src, bops.g_dst, a, 0.5),
        bops.s_blocks.bcols, Xb, Xb, eacc0)
    print(f"edge_gram_accum (per-iter op):  {t:8.2f} ms")

    t = timeit(lambda i, j, x: jnp.sum(x[i] * x[j], axis=1),
               a_i, a_j, V)
    print(f"eF edge gather dot (E_pad):     {t:8.2f} ms")

    def lanczos_fn(b, v):
        return lanczos_expm_multiply(
            lambda u: B.bcsr_spmm(b, u), v, m=m, reorth=True,
            small_method="taylor_ss", norm_bound=7.5)[0]

    t = timeit(lanczos_fn, bops.s_blocks, V)
    print(f"lanczos m={m} (spmm only op):     {t:8.2f} ms")

    def lanczos_noreorth(b, v):
        return lanczos_expm_multiply(
            lambda u: B.bcsr_spmm(b, u), v, m=m, reorth=False,
            small_method="taylor_ss", norm_bound=7.5)[0]

    t = timeit(lanczos_noreorth, bops.s_blocks, V)
    print(f"lanczos m={m} no reorth:          {t:8.2f} ms")

    # vector phase (softmax etc.) proxy: a few elementwise passes over [Kp]
    t = timeit(lambda v: jnp.sum(v * v, axis=1), V)
    print(f"rowwise reduce [nrows, D]:      {t:8.2f} ms")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=int, default=183)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--no-transpose", action="store_true")
    ap.add_argument("--m", type=int, default=8)
    a = ap.parse_args()
    main(a.cell, a.block, a.bf16, a.no_transpose, a.m)
