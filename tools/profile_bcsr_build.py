"""Host-side phase profile of the BCSR operand build (VERDICT r4 weak #7).

Times each stage of ops/bcsr.py::bcsr_operands_from_state separately so the
native-builder effort targets the real long pole.  Runs entirely on the host
CPU (JAX_PLATFORMS=cpu) — it needs no accelerator.

Usage: python tools/profile_bcsr_build.py [cell]   (cell=183 -> K~100k,
cell=580 -> K~1M, the MILLION_LINK_E2E config)
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools

import numpy as np

print = functools.partial(print, flush=True)


def main(cell=183):
    import scipy.sparse

    from sig_sdp_mmw_tpu.core.ell import build_st_csr
    from sig_sdp_mmw_tpu.env.large import LargeEnv
    from sig_sdp_mmw_tpu.ops.bcsr import _bcsr_arrays_np

    t0 = time.perf_counter()
    env = LargeEnv(cell, 75e-4, seed=0)
    S, Q, h = env.generate_state_csr()
    K = S.shape[0]
    print(f"generate K={K} nnz_S={S.nnz}  [{time.perf_counter()-t0:.1f}s]")

    def tick(label, fn):
        t = time.perf_counter()
        out = fn()
        print(f"  {label:<28s} {time.perf_counter()-t:7.2f}s")
        return out

    Br, Bc = 8, 128
    St = tick("build_st_csr", lambda: build_st_csr(S, Q))
    tick("sort_indices", St.sort_indices)
    import math
    lcm = Br * Bc // math.gcd(Br, Bc)
    nr = ((K + lcm - 1) // lcm) * lcm

    arrs = tick("_bcsr_arrays_np(S~)",
                lambda: _bcsr_arrays_np(St, (Br, Bc), pad_rows_to=nr,
                                        dtype=np.float32,
                                        return_entry_maps=True))
    s_bcols, s_vals, _, (ebr, eslot, erloc, ecloc) = arrs
    maxblk = s_bcols.shape[1]
    nnz = St.nnz
    print(f"  maxblk={maxblk} blocks {s_vals.nbytes/2**30:.2f} GiB")

    def gram_maps():
        src_pos = ((ebr * Br + erloc) * Bc + ecloc).astype(np.int64)
        counts_s = np.bincount(eslot, minlength=maxblk)
        max_e = max(int(counts_s.max(initial=0)), 1)
        g_src = np.zeros((maxblk, max_e), np.int32)
        g_dst = np.full((maxblk, max_e), nnz, np.int32)
        order = np.argsort(eslot, kind="stable")
        within = np.arange(nnz) - np.concatenate(
            ([0], np.cumsum(counts_s)))[eslot[order]]
        g_src[eslot[order], within] = src_pos[order]
        g_dst[eslot[order], within] = np.arange(nnz)[order]
    tick("gram maps", gram_maps)

    def weights():
        P = St.copy()
        P.data = np.ones_like(P.data)
        B2 = P.multiply(P.transpose()).tocsr()
        Wm = (P - 0.5 * B2).tocsr()
        Wm.sort_indices()
        return Wm
    tick("weights P.multiply(P^T)", weights)

    def q_layout():
        Qu = scipy.sparse.triu(Q.tocsr(), k=1).tocoo()
        E = Qu.nnz
        ii = np.concatenate([Qu.row, Qu.col]).astype(np.int64)
        jj = np.concatenate([Qu.col, Qu.row]).astype(np.int64)
        bi, bj = ii // Br, jj // Bc
        blk_id = bi * (nr // Bc) + bj
        uniq = np.unique(blk_id)
        return uniq.size
    tick("q edge layout", q_layout)

    def cast_bf16():
        import ml_dtypes
        return s_vals.astype(ml_dtypes.bfloat16)
    tick("bf16 cast (numpy)", cast_bf16)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 183)
