"""Million-link pipeline (BASELINE.json config 5) on one device: generation,
memory budget, segmented block-native MMW solve with a per-segment
convergence (UB) curve, greedy rounding and independent verification.

Every phase is guarded; whatever fails is recorded with numbers, so the
artifact is either a demonstration or a quantified failure analysis.
Phases:

1. generate cell~580 (K ~ 1.0M links) with the native C++ builder;
2. build the SLIM solver state + lean BCSR operands (bf16 blocks, no
   stored transpose) and tabulate the byte budget vs the device's memory;
3. segmented solve (--segment N iterations per device execution) logging
   the averaged-X max violation at each boundary;
4. (--rounding) greedy rounding attempts + host CSR verification.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools

import numpy as np

print = functools.partial(print, flush=True)


def _gb(nbytes):
    return round(nbytes / 2**30, 3)


def tree_bytes(tree):
    import jax

    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree)
               if hasattr(x, "dtype"))


def main(cell=580, rho=75e-4, seed=0, nit=3, block=128, d_pad=None,
         do_rounding=False, out_path=None, lanczos_m=8, row_chunk=2048,
         skip_warm=False, nattempt=1, segment=0, z_extra=4,
         store_transpose=False, gram_mode="edge"):
    import jax
    import jax.numpy as jnp

    rec = {"config": {"cell": cell, "rho": rho, "seed": seed, "nit": nit,
                      "block": block},
           "device": str(jax.devices()[0]).split(":")[0],
           "phases_s": {}, "budget_gb": {}}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_path = out_path or os.path.join(repo, "MILLION_LINK.json")

    def save():
        rec["total_s"] = round(sum(rec["phases_s"].values()), 1)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {out_path}")

    try:
        from sig_sdp_mmw_tpu.env.large import LargeEnv

        t0 = time.time()
        env = LargeEnv(cell, rho, seed=seed)
        S, Q, h = env.generate_state_csr()
        K = S.shape[0]
        rec["K"] = K
        rec["nnz_S"] = int(S.nnz)
        rec["nnz_Q"] = int(Q.nnz)
        rec["phases_s"]["generate"] = round(time.time() - t0, 1)
        print(f"generate: K={K} nnz(S)={S.nnz} nnz(Q)={Q.nnz} "
              f"[{rec['phases_s']['generate']}s]")
    except Exception as exc:  # noqa: BLE001
        rec["generate_error"] = f"{type(exc).__name__}: {exc}"[:400]
        save()
        raise

    try:
        from sig_sdp_mmw_tpu.core.ell import ell_slim_from_csr

        t0 = time.time()
        # Memory-lean solve path: the BCSR-native solver only needs the
        # [Kp]/[E_pad] slim vectors — the full EllState (~2.5 GB of ELL
        # index/value arrays) is never built unless --rounding asks for it.
        import math as _math
        Br, Bc = (block, block) if isinstance(block, int) else block
        lcm = Br * Bc // _math.gcd(Br, Bc)
        Kp_pad = ((K + lcm - 1) // lcm) * lcm
        slim = ell_slim_from_csr(S, Q, h, pad_rows_to=Kp_pad)
        rec["phases_s"]["slim_build"] = round(time.time() - t0, 1)
        rec["budget_gb"]["slim_state"] = _gb(tree_bytes(slim))
        print(f"slim: Kp={slim.Kp} E_pad={slim.E_pad} "
              f"{rec['budget_gb']['slim_state']} GB "
              f"[{rec['phases_s']['slim_build']}s]")
    except Exception as exc:  # noqa: BLE001
        rec["ell_error"] = f"{type(exc).__name__}: {exc}"[:400]
        save()
        raise

    try:
        from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

        t0 = time.time()
        ops = bcsr_operands_from_state(S, Q, block=block,
                                       dtype=jnp.bfloat16,
                                       store_transpose=store_transpose,
                                       weights_dtype=jnp.bfloat16)
        rec["phases_s"]["bcsr_build"] = round(time.time() - t0, 1)
        rec["budget_gb"]["bcsr_operands"] = _gb(tree_bytes(ops))
        rec["bcsr_Kb"] = int(ops.s_blocks.Kb)
        rec["bcsr_maxblk"] = int(ops.s_blocks.bcols.shape[1])
        rec["block_fill_pct"] = round(
            100 * S.nnz / ops.s_blocks.blocks.size, 3)
        print(f"bcsr: Kb={rec['bcsr_Kb']} maxblk={rec['bcsr_maxblk']} "
              f"fill={rec['block_fill_pct']}% "
              f"{rec['budget_gb']['bcsr_operands']} GB "
              f"[{rec['phases_s']['bcsr_build']}s]")
    except Exception as exc:  # noqa: BLE001
        rec["bcsr_error"] = f"{type(exc).__name__}: {exc}"[:400]
        save()
        raise

    # Working-set estimate for the solver at sketch width D.
    lb = int(np.diff(Q.indptr).max()) + 1
    Z = float(lb + z_extra)
    D_pad = d_pad if d_pad is not None else ((int(Z) * 2 + 15) // 16) * 16
    rec["lb"] = lb
    rec["Z_probe"] = Z
    rec["D_pad"] = D_pad
    # V-sized f32 buffers on the hot path: sketch V, Lanczos vectors
    # (3 live), averaged weights (nnz), edge values (nnz + E).
    v_bytes = slim.Kp * D_pad * 4
    work = 6 * v_bytes + 3 * S.nnz * 4 + 2 * slim.E_pad * 4
    rec["budget_gb"]["solver_working_set_est"] = _gb(work)
    rec["budget_gb"]["total_est"] = round(
        rec["budget_gb"]["slim_state"] + rec["budget_gb"]["bcsr_operands"]
        + rec["budget_gb"]["solver_working_set_est"], 3)
    dev = jax.devices()[0]
    mem = (dev.memory_stats() or {}).get("bytes_limit")
    rec["budget_gb"]["device_bytes_limit"] = _gb(mem) if mem else None
    print(f"budget: {rec['budget_gb']}")

    try:
        from sig_sdp_mmw_tpu.models.mmw_ell import (mmw_ell_ub_from_carry,
                                                     mmw_solve_ell)

        t0 = time.time()
        slim = jax.device_put(slim, dev)
        ops = jax.device_put(ops, dev)
        jax.block_until_ready((slim, ops))
        rec["phases_s"]["device_transfer"] = round(time.time() - t0, 1)
        print(f"transfer: [{rec['phases_s']['device_transfer']}s]")

        kw = dict(nit=nit, eta=0.05, D_pad=D_pad, rank_pad=D_pad,
                  lanczos_m=lanczos_m, spmm_row_chunk=row_chunk,
                  gram_mode=gram_mode)
        key = jax.random.PRNGKey(0)
        if segment and segment < nit:
            # Segmented execution: ceil(nit/segment)-many short device
            # executions passing the carry, with the UB read at each
            # boundary.  Bit-identical to single-shot (absolute iteration
            # indices).
            # num_steps is STATIC (fori trip count), it_start traced: one
            # executable serves every segment.
            seg_fn = jax.jit(lambda e, k, b, c, i0: mmw_solve_ell(
                e, Z, key=k, bcsr=b, carry_in=c, it_start=i0,
                num_steps=min(segment, nit), return_carry=True, **kw))
            fin_fn = jax.jit(lambda e, k, b, c: mmw_solve_ell(
                e, Z, key=k, bcsr=b, carry_in=c, it_start=nit, num_steps=0,
                **kw))
            # Convergence telemetry: the averaged-X max violation (the
            # reference's LOG_GAP UB) at every segment boundary; the
            # scalar pull also ends each segment before the next starts.
            ub_fn = jax.jit(lambda e, cc, n: mmw_ell_ub_from_carry(
                e, Z, cc, n))
            ub_curve = []
            t0 = time.time()
            c = seg_fn(slim, key, ops, None, 0)
            ub_i = float(ub_fn(slim, c, min(segment, nit)))
            ub_curve.append([min(segment, nit), round(ub_i, 4)])
            rec["phases_s"]["compile"] = round(time.time() - t0, 1)
            rec["segment"] = segment
            print(f"segment 0..{min(segment, nit)} done ub={ub_i:.4f} "
                  f"(incl compile {rec['phases_s']['compile']}s)")
            t0 = time.time()
            i0 = min(segment, nit)
            while i0 < nit:
                i1 = min(i0 + segment, nit)
                if i1 - i0 == min(segment, nit):
                    c = seg_fn(slim, key, ops, c, i0)
                else:           # short tail segment: its own executable
                    c = jax.jit(lambda e, k, b, cc, j0: mmw_solve_ell(
                        e, Z, key=k, bcsr=b, carry_in=cc, it_start=j0,
                        num_steps=i1 - i0, return_carry=True, **kw)
                    )(slim, key, ops, c, i0)
                ub_i = float(ub_fn(slim, c, i1))
                ub_curve.append([i1, round(ub_i, 4)])
                print(f"segment {i0}..{i1} done ub={ub_i:.4f} "
                      f"[{time.time() - t0:.0f}s]")
                i0 = i1
            rec["ub_curve"] = ub_curve
            out = fin_fn(slim, key, ops, c)
            ub = float(out.ub_final)
            rec["phases_s"]["solve"] = round(time.time() - t0, 1)
            rec["ub_final"] = ub
            rec["s_per_iter"] = round(
                rec["phases_s"]["solve"] / max(nit - segment, 1), 2)
            print(f"solve nit={nit} (segmented): ub={ub:.4f} "
                  f"[{rec['phases_s']['solve']}s, "
                  f"{rec['s_per_iter']}s/iter steady]")
        else:
            fn = jax.jit(lambda e, k, b: mmw_solve_ell(e, Z, key=k, bcsr=b,
                                                       **kw))
            t0 = time.time()
            lowered = fn.lower(slim, key, ops)
            compiled = lowered.compile()
            rec["phases_s"]["compile"] = round(time.time() - t0, 1)
            mem = compiled.memory_analysis()
            if mem is not None:
                rec["budget_gb"]["xla_argument"] = _gb(
                    mem.argument_size_in_bytes)
                rec["budget_gb"]["xla_temp"] = _gb(mem.temp_size_in_bytes)
                rec["budget_gb"]["xla_peak_extra"] = _gb(
                    mem.temp_size_in_bytes + mem.output_size_in_bytes)
            print(f"compile: [{rec['phases_s']['compile']}s] "
                  f"xla temp={rec['budget_gb'].get('xla_temp')} GB")

            t0 = time.time()
            out = compiled(slim, key, ops)
            ub = float(out.ub_final)      # scalar pull = completion barrier
            rec["phases_s"]["solve"] = round(time.time() - t0, 1)
            rec["ub_final"] = ub
            rec["s_per_iter_first"] = round(rec["phases_s"]["solve"] / nit, 2)
            print(f"solve nit={nit}: ub={ub:.4f} "
                  f"[{rec['phases_s']['solve']}s, "
                  f"{rec['s_per_iter_first']}s/iter incl warm]")

            if not skip_warm:
                t0 = time.time()
                out = compiled(slim, jax.random.fold_in(key, 1), ops)
                ub = float(out.ub_final)
                warm = time.time() - t0
                rec["phases_s"]["solve_warm"] = round(warm, 1)
                rec["s_per_iter"] = round(warm / nit, 2)
                print(f"warm solve: {rec['s_per_iter']}s/iter")
    except Exception as exc:  # noqa: BLE001
        rec["solve_error"] = f"{type(exc).__name__}: {exc}"[:600]
        save()
        print(f"SOLVE FAILED: {rec['solve_error']}")
        return rec

    if do_rounding:
        try:
            from sig_sdp_mmw_tpu.models.rounding_ell import (
                rounding_ell, verify_assignment_csr)

            t0 = time.time()
            # Rounding needs the full ELL state; built only now, after the
            # solver's big buffers are no longer growing the peak.  Padded
            # to the BCSR row count so gX and the state line up.
            ell = env.generate_ell(pad_rows_to=Kp_pad)
            rec["budget_gb"]["ell_state"] = _gb(tree_bytes(ell))
            z_vec, _, rem = rounding_ell(int(Z), out.X_half, ell,
                                         jax.random.PRNGKey(7),
                                         nattempt=nattempt,
                                         Z_pad=((int(Z) + 15) // 16) * 16)
            rec["phases_s"]["rounding"] = round(time.time() - t0, 1)
            rec["rounding_rem"] = int(rem)
            ok, ni, na = verify_assignment_csr(S, Q, h, z_vec)
            rec["verified"] = dict(ok=bool(ok), interf=int(ni), asso=int(na))
            print(f"rounding: rem={rem} verify={rec['verified']} "
                  f"[{rec['phases_s']['rounding']}s]")
        except Exception as exc:  # noqa: BLE001
            rec["rounding_error"] = f"{type(exc).__name__}: {exc}"[:400]

    save()
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=int, default=580)
    ap.add_argument("--rho", type=float, default=75e-4)
    ap.add_argument("--nit", type=int, default=3)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--d-pad", type=int, default=None)
    ap.add_argument("--lanczos-m", type=int, default=8)
    ap.add_argument("--rounding", action="store_true")
    ap.add_argument("--row-chunk", type=int, default=2048)
    ap.add_argument("--skip-warm", action="store_true")
    ap.add_argument("--segment", type=int, default=0)
    ap.add_argument("--z-extra", type=int, default=4)
    ap.add_argument("--nattempt", type=int, default=1)
    ap.add_argument("--store-transpose", action="store_true")
    ap.add_argument("--gram", type=str, default="edge")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, a.rho, nit=a.nit, block=a.block, d_pad=a.d_pad,
         do_rounding=a.rounding, out_path=a.out, lanczos_m=a.lanczos_m,
         row_chunk=a.row_chunk, skip_warm=a.skip_warm, nattempt=a.nattempt,
         segment=a.segment, z_extra=a.z_extra,
         store_transpose=a.store_transpose, gram_mode=a.gram)
