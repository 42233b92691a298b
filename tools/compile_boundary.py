"""Locate the one-device compile/memory boundary of the block-native MMW
solver along the K (links) axis.

For each cell size, build the ELL state + BCSR operands once, then AOT-lower
and compile the nit-iteration solver, recording XLA's temp/argument memory
analysis (or the failure).  No solve is run — this maps where the device's
memory stops taking the program, with numbers instead of guesses.
"""

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

print = functools.partial(print, flush=True)


def try_cell(cell, block, d_pad, lanczos_m, nit=3):
    import jax
    import jax.numpy as jnp

    from sig_sdp_mmw_tpu.env.large import LargeEnv
    from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    rec = {"cell": cell, "block": block, "d_pad": d_pad,
           "lanczos_m": lanczos_m}
    env = LargeEnv(cell, 75e-4, seed=0)
    S, Q, h = env.generate_state_csr()
    rec["K"] = S.shape[0]
    rec["nnz_S"] = int(S.nnz)
    t0 = time.time()
    ell = env.generate_ell()
    ops = bcsr_operands_from_state(S, Q, block=block, dtype=jnp.bfloat16,
                                   store_transpose=False,
                                   weights_dtype=jnp.bfloat16)
    rec["build_s"] = round(time.time() - t0, 1)
    lb = int(np.diff(Q.indptr).max()) + 1
    Z = float(lb + 4)
    D_pad = d_pad if d_pad is not None else ((int(Z) * 2 + 15) // 16) * 16
    rec["D_pad"] = D_pad

    fn = jax.jit(lambda e, k, b: mmw_solve_ell(
        e, Z, nit=nit, eta=0.05, D_pad=D_pad, rank_pad=D_pad,
        key=k, lanczos_m=lanczos_m, bcsr=b))
    try:
        t0 = time.time()
        compiled = fn.lower(ell, jax.random.PRNGKey(0), ops).compile()
        rec["compile_s"] = round(time.time() - t0, 1)
        mem = compiled.memory_analysis()
        if mem is not None:
            rec["xla_temp_gb"] = round(mem.temp_size_in_bytes / 2**30, 3)
            rec["xla_arg_gb"] = round(mem.argument_size_in_bytes / 2**30, 3)
        rec["compiled"] = True
    except Exception as exc:  # noqa: BLE001
        rec["compiled"] = False
        rec["error"] = f"{type(exc).__name__}: {exc}"[:200]
    print(json.dumps(rec))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, nargs="+", default=[520, 550, 580])
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--d-pad", type=int, default=None)
    ap.add_argument("--lanczos-m", type=int, default=6)
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args(argv)
    rows = [try_cell(c, a.block, a.d_pad, a.lanczos_m) for c in a.cells]
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
