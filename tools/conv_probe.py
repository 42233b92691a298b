"""Quick convergence probe at K=100k: does the block-native solve reach the
reference's ub<=0.08 plateau (eta=0.04, nit=625 — sim_convergence_rho.py
spec), and does bf16 block storage floor it?  Informs the million-link
north-star configuration before spending hours of accelerator time on it.
"""

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

print = functools.partial(print, flush=True)


def main(cell=183, eta=0.04, nit=625, seg=125, z_extra=4, lanczos_m=8):
    import jax
    import jax.numpy as jnp

    from sig_sdp_mmw_tpu.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_tpu.env.large import generate_large_state_csr
    from sig_sdp_mmw_tpu.models.mmw_ell import (mmw_ell_ub_from_carry,
                                                mmw_solve_ell)
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    S, Q, h = generate_large_state_csr(cell, 75e-4, seed=0)
    K = S.shape[0]
    slim = ell_slim_from_csr(S, Q, h)
    lb = int(np.diff(Q.indptr).max()) + 1
    Z = float(lb + z_extra)
    D_pad = ((int(Z) * 2 + 15) // 16) * 16
    print(f"K={K} lb={lb} Z={Z} D_pad={D_pad} eta={eta} nit={nit}")

    out = {"K": K, "Z": Z, "eta": eta, "nit": nit, "runs": {}}
    for tag, dt in (("bf16", jnp.bfloat16), ("f32", np.float32)):
        ops = bcsr_operands_from_state(S, Q, block=128, dtype=dt,
                                       store_transpose=True)
        ops = jax.device_put(ops)
        slim_d = jax.device_put(slim)
        jax.block_until_ready(ops.s_blocks.blocks)

        kw = dict(nit=nit, eta=eta, D_pad=D_pad, rank_pad=D_pad,
                  lanczos_m=lanczos_m)
        key = jax.random.PRNGKey(0)
        seg_fn = jax.jit(lambda e, k, b, c, i0: mmw_solve_ell(
            e, Z, key=k, bcsr=b, carry_in=c, it_start=i0, num_steps=seg,
            return_carry=True, **kw))
        ub_fn = jax.jit(lambda e, cc, n: mmw_ell_ub_from_carry(e, Z, cc, n))
        t0 = time.time()
        c = None
        curve = []
        for i0 in range(0, nit, seg):
            c = seg_fn(slim_d, key, ops, c, i0)
            u = float(ub_fn(slim_d, c, i0 + seg))
            curve.append([i0 + seg, round(u, 4)])
            print(f"[{tag}] it={i0+seg} ub={u:.4f} [{time.time()-t0:.0f}s]")
        out["runs"][tag] = curve
        del ops

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "CONV_PROBE_100K.json"), "w") as f:
        json.dump(out, f, indent=1)
    print("saved CONV_PROBE_100K.json")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=int, default=183)
    ap.add_argument("--eta", type=float, default=0.04)
    ap.add_argument("--nit", type=int, default=625)
    ap.add_argument("--seg", type=int, default=125)
    ap.add_argument("--z-extra", type=int, default=4)
    a = ap.parse_args()
    main(a.cell, a.eta, a.nit, a.seg, a.z_extra)
