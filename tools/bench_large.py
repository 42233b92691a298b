"""Benchmark the ELL sparse MMW solver at large K on one accelerator.

Config 4 of BASELINE.json: ~100k-link sparse graph, one device.
Reports per-iteration time and sustained nnz*D throughput.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools

import numpy as np

print = functools.partial(print, flush=True)


def main(cell=183, rho=75e-4, nit=20, lanczos_m=8, paths="bcsr,ell",
         block=128, bf16=False, no_transpose=False, skip_ellbuild=False):
    import jax

    from sig_sdp_mmw_tpu.core.ell import ell_from_scipy
    from sig_sdp_mmw_tpu.env.large import generate_large_state_csr
    from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell

    t0 = time.time()
    S, Q, h = generate_large_state_csr(cell, rho, seed=0)
    K = S.shape[0]
    print(f"generated K={K} nnz(S)={S.nnz} nnz(Q)={Q.nnz} "
          f"in {time.time()-t0:.1f}s")

    t0 = time.time()
    ell = ell_from_scipy(S, Q, h)
    print(f"ELL build {time.time()-t0:.1f}s degS={ell.s_cols.shape[1]} "
          f"E_pad={ell.E_pad} Kp={ell.Kp}")

    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    import jax.numpy as jnp

    t0 = time.time()
    bops = bcsr_operands_from_state(
        S, Q, block=block,
        dtype=jnp.bfloat16 if bf16 else np.float32,
        store_transpose=not no_transpose)
    bpb = bops.s_blocks.blocks.dtype.itemsize
    nmat = 2 + (0 if no_transpose else 1)
    print(f"BCSR build {time.time()-t0:.1f}s Kb={bops.s_blocks.Kb} "
          f"maxblk={bops.s_blocks.bcols.shape[1]} "
          f"maxblkQ={bops.q_bcols.shape[1]} "
          f"blocks={bops.s_blocks.blocks.size*bpb/1e6:.0f}MB x{nmat}")

    # Z scale: max association degree + margin.
    lb = int(np.diff(Q.indptr).max()) + 1
    Z = float(lb + 8)
    D_pad = ((int(Z) * 2 + 15) // 16) * 16
    print(f"lb={lb} Z={Z} D_pad={D_pad}")

    key = jax.random.PRNGKey(0)
    t0 = time.time()
    dev = jax.devices()[0]
    ell = jax.device_put(ell, dev)
    bops = jax.device_put(bops, dev)
    jax.block_until_ready((ell, bops))
    print(f"device transfer to {dev.device_kind} {time.time()-t0:.1f}s")

    for name in paths.split(","):
        # bcsr must be a jit ARGUMENT, not a closure capture — captured
        # operands become giant jaxpr constants (GBs embedded in the program).
        if name == "bcsr":
            fn = jax.jit(lambda e, k, b: mmw_solve_ell(
                e, Z, nit=nit, eta=0.05, D_pad=D_pad, rank_pad=D_pad, key=k,
                lanczos_m=lanczos_m, reorth=True, bcsr=b))
            fargs = (ell, key, bops)
        else:
            fn = jax.jit(lambda e, k: mmw_solve_ell(
                e, Z, nit=nit, eta=0.05, D_pad=D_pad, rank_pad=D_pad, key=k,
                lanczos_m=lanczos_m, reorth=True))
            fargs = (ell, key)
        t0 = time.time()
        lowered = fn.lower(*fargs)
        print(f"[{name}] lower {time.time()-t0:.1f}s")
        t0 = time.time()
        compiled = lowered.compile()
        print(f"[{name}] compile {time.time()-t0:.1f}s")
        t0 = time.time()
        out = compiled(*fargs)
        print(f"[{name}] first run ub={float(out.ub_final):.4f} "
              f"{time.time()-t0:.1f}s")

        times = []
        for i in range(3):
            k = jax.random.fold_in(key, i)
            t0 = time.perf_counter()
            out = compiled(*((fargs[0], k) + fargs[2:]))
            float(out.ub_final)
            times.append(time.perf_counter() - t0)
        t = float(np.median(times))
        per_it = t / nit
        nnz = S.nnz
        flops = (2 * lanczos_m + 4) * 2 * nnz * D_pad
        print(f"[{name}] solve {t*1e3:.1f} ms nit={nit} -> "
              f"{per_it*1e3:.2f} ms/iter, {nit/t:.1f} it/s, "
              f"~{flops/per_it/1e9:.1f} GFLOP/s useful sparse chain")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=int, default=183)
    ap.add_argument("--rho", type=float, default=75e-4)
    ap.add_argument("--nit", type=int, default=20)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--paths", type=str, default="bcsr,ell")
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--no-transpose", action="store_true")
    a = ap.parse_args()
    main(a.cell, a.rho, a.nit, a.m, a.paths, a.block, a.bf16, a.no_transpose)
