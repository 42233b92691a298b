"""Million-link NORTH STAR end-to-end (VERDICT r4 task 1): min-Z binary
search + convergence-to-plateau + rounding + independent verification +
BLER evaluation at K ~ 1M on one chip.

Reference semantics being matched at scale:
* search: ``sim_src/alg/binary_search_relaxation.py:44-72`` (bisection with
  the both-bounds-infeasible window shift);
* convergence spec: ``sim_script/ton_major_rv/sim_convergence_rho.py:29-51``
  (eta, nit = ceil(1/eta^2), curve of the averaged-X max violation at the
  minimum feasible Z);
* BLER: ``sim_src/env/env.py:226-232`` via the sparse O(K*deg) evaluator.

Engineering: Z is a TRACED argument and D_pad is fixed, so ONE compiled
segment executable serves every probe of the search and every segment of
the final convergence run (a per-Z recompile would dominate the
search).  Rounding state (full EllState) stays on the host and streams to
the device per call, keeping device memory for the solver.

Writes MILLION_LINK_E2E.json incrementally after every phase.
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


def main(cell=580, rho=75e-4, seed=0, block=128, d_pad=48,
         nit_probe=120, eta_probe=0.05, nit_conv=625, eta_conv=0.04,
         segment=5, lanczos_m=8, nattempt=3, z_pad=32,
         store_transpose=True, gram_mode="edge", row_chunk=2048,
         out_path=None, skip_bler=False, win=8, platform=None):
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    import jax.numpy as jnp

    from sig_sdp_mmw_tpu.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_tpu.env.large import LargeEnv
    from sig_sdp_mmw_tpu.models.mmw_ell import (mmw_ell_ub_from_carry,
                                                mmw_solve_ell)
    from sig_sdp_mmw_tpu.models.rounding_ell import (rounding_native_csr,
                                                     verify_assignment_csr)
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_path = out_path or os.path.join(repo, "MILLION_LINK_E2E.json")
    rec = {"config": dict(cell=cell, rho=rho, seed=seed, block=block,
                          d_pad=d_pad, nit_probe=nit_probe,
                          eta_probe=eta_probe, nit_conv=nit_conv,
                          eta_conv=eta_conv, segment=segment,
                          lanczos_m=lanczos_m, nattempt=nattempt,
                          store_transpose=store_transpose,
                          gram_mode=gram_mode),
           "device": str(jax.devices()[0]).split(":")[0],
           "phases_s": {}, "probes": []}

    def save():
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)

    # ---- state -------------------------------------------------------------
    t0 = time.time()
    env = LargeEnv(cell, rho, seed=seed)
    S, Q, h = env.generate_state_csr()
    K = S.shape[0]
    rec["K"] = K
    rec["nnz_S"] = int(S.nnz)
    rec["phases_s"]["generate"] = round(time.time() - t0, 1)
    print(f"generate K={K} nnz={S.nnz} [{rec['phases_s']['generate']}s]")

    t0 = time.time()
    import math as _math
    Br, Bc = (block, block) if isinstance(block, int) else block
    lcm = Br * Bc // _math.gcd(Br, Bc)
    Kp_pad = ((K + lcm - 1) // lcm) * lcm
    slim = ell_slim_from_csr(S, Q, h, pad_rows_to=Kp_pad)
    ops = bcsr_operands_from_state(S, Q, block=block, dtype=jnp.bfloat16,
                                   store_transpose=store_transpose,
                                   weights_dtype=jnp.bfloat16)
    rec["phases_s"]["build"] = round(time.time() - t0, 1)
    rec["bcsr_maxblk"] = int(ops.s_blocks.bcols.shape[1])
    rec["block_fill_pct"] = round(100 * S.nnz / ops.s_blocks.blocks.size, 3)
    print(f"build maxblk={rec['bcsr_maxblk']} fill={rec['block_fill_pct']}% "
          f"[{rec['phases_s']['build']}s]")

    t0 = time.time()
    dev = jax.devices()[0]
    slim = jax.device_put(slim, dev)
    ops = jax.device_put(ops, dev)
    jax.block_until_ready((slim, ops))
    rec["phases_s"]["transfer"] = round(time.time() - t0, 1)

    # Host-side S̃^T CSR for the native greedy rounding (built once; no
    # EllState needed — csrc/sig_native.cpp::sig_greedy_round is the
    # production large-K rounding path).
    t0 = time.time()
    from sig_sdp_mmw_tpu.core.ell import build_st_csr
    StT_host = build_st_csr(S, Q).transpose().tocsr()
    Q_host = Q.tocsr()
    rec["phases_s"]["stt_build"] = round(time.time() - t0, 1)
    save()

    # ---- one executable for every probe ------------------------------------
    def seg_kw(nit, eta, rsvd_iters=3):
        return dict(nit=nit, eta=eta, D_pad=d_pad, rank_pad=d_pad,
                    lanczos_m=lanczos_m, spmm_row_chunk=row_chunk,
                    gram_mode=gram_mode, rsvd_iters=rsvd_iters)

    def make_fns(nit, eta, rsvd_iters=3):
        kw = seg_kw(nit, eta, rsvd_iters)
        seg_fn = jax.jit(lambda e, Zt, k, b, c, i0: mmw_solve_ell(
            e, Zt, key=k, bcsr=b, carry_in=c, it_start=i0,
            num_steps=segment, return_carry=True, **kw))
        fin_fn = jax.jit(lambda e, Zt, k, b, c: mmw_solve_ell(
            e, Zt, key=k, bcsr=b, carry_in=c, it_start=nit, num_steps=0,
            **kw))
        ub_fn = jax.jit(lambda e, Zt, cc, n: mmw_ell_ub_from_carry(
            e, Zt, cc, n))
        return seg_fn, fin_fn, ub_fn

    def run_solve(Z, nit, eta, fns, key, curve_every=None, tag=""):
        seg_fn, fin_fn, ub_fn = fns
        Zt = jnp.float32(Z)
        c = None
        curve = []
        t0 = time.time()
        for i0 in range(0, nit, segment):
            n = min(segment, nit - i0)
            if n != segment:       # tail (only when nit % segment != 0)
                c = jax.jit(lambda e, Zt, k, b, cc, j0, n=n: mmw_solve_ell(
                    e, Zt, key=k, bcsr=b, carry_in=cc, it_start=j0,
                    num_steps=n, return_carry=True, **seg_kw(nit, eta))
                )(slim, Zt, key, ops, c, i0)
            else:
                c = seg_fn(slim, Zt, key, ops, c, i0)
            i1 = i0 + n
            if curve_every and (i1 % curve_every == 0 or i1 == nit):
                u = float(ub_fn(slim, Zt, c, i1))
                curve.append([i1, round(u, 4)])
                print(f"  {tag} it={i1} ub={u:.4f} [{time.time()-t0:.0f}s]")
            else:
                # Scalar pull: each segment ends before the next starts.
                float(c["eaD"][0])
                print(f"  {tag} seg..{i1} [{time.time()-t0:.0f}s]")
        out = fin_fn(slim, Zt, key, ops, c)
        u = float(out.ub_final)
        dt = time.time() - t0
        print(f"  {tag} solve ub={u:.4f} [{dt:.0f}s, "
              f"{dt/nit:.2f}s/it]")
        return out, u, curve, dt

    def round_and_verify(Z, X_half, key, tag=""):
        t0 = time.time()
        z_vec, _, rem = rounding_native_csr(int(Z), np.asarray(X_half), S,
                                            Q_host, h, key,
                                            nattempt=nattempt,
                                            StT_csr=StT_host)
        dt_r = time.time() - t0
        t0 = time.time()
        ok, ni, na = verify_assignment_csr(S, Q, h, z_vec)
        dt_v = time.time() - t0
        print(f"  {tag} rounding rem={rem} verify ok={ok} "
              f"interf={ni} asso={na} [{dt_r:.0f}s + {dt_v:.0f}s]")
        return z_vec, int(rem), bool(ok), round(dt_r, 1)

    # Probes use one subspace iteration in the factorization epilogue — the
    # rounding factor tolerates it and the 3-iteration epilogue costs ~2
    # solver-minutes per probe at 1M.
    probe_fns = make_fns(nit_probe, eta_probe, rsvd_iters=1)
    key = jax.random.PRNGKey(17)

    # ---- min-Z bisection (reference window semantics) ----------------------
    lb = int(np.diff(Q.indptr).max()) + 1
    hi0 = lb + win
    rec["lb"] = lb
    lo, hi = lb, hi0
    feasible = {}          # Z -> z_vec
    infeasible = set()
    t_search = time.time()
    nprobe = 0
    while lo <= hi:
        mid = (lo + hi + 1) // 2
        nprobe += 1
        print(f"probe #{nprobe}: Z={mid} window=[{lo},{hi}]")
        out, u, _, dt_s = run_solve(mid, nit_probe, eta_probe, probe_fns,
                                    jax.random.fold_in(key, mid),
                                    tag=f"Z={mid}")
        z_vec, rem, ok, dt_r = round_and_verify(
            mid, out.X_half, jax.random.fold_in(key, 1000 + mid),
            tag=f"Z={mid}")
        rec["probes"].append(dict(Z=mid, ub=round(u, 4), rem=rem,
                                  verified=ok, solve_s=round(dt_s, 1),
                                  round_s=dt_r))
        save()
        if rem == 0 and ok:
            feasible[mid] = z_vec
            hi = mid - 1
        else:
            infeasible.add(mid)
            lo = mid + 1
        if not feasible and lo > hi:
            # Both-bounds-infeasible window shift (reference :65-67).
            if hi >= lb + 64:
                raise RuntimeError(f"no feasible Z up to {hi}")
            lo, hi = hi + 1, hi + max(hi - lo, 2)
            print(f"window shift -> [{lo},{hi}]")
    Z_fin = min(feasible)
    rec["Z_fin"] = int(Z_fin)
    rec["phases_s"]["search"] = round(time.time() - t_search, 1)
    rec["n_probes"] = nprobe
    print(f"search: Z_fin={Z_fin} after {nprobe} probes "
          f"[{rec['phases_s']['search']}s]")
    save()

    # ---- convergence at Z_fin (reference spec eta, nit=ceil(1/eta^2)) ------
    conv_fns = make_fns(nit_conv, eta_conv)
    t0 = time.time()
    out, u, curve, dt_s = run_solve(Z_fin, nit_conv, eta_conv, conv_fns,
                                    jax.random.fold_in(key, 777),
                                    curve_every=max(segment, 25),
                                    tag=f"conv Z={Z_fin}")
    rec["conv_curve"] = curve
    rec["ub_final"] = round(u, 4)
    rec["phases_s"]["convergence"] = round(time.time() - t0, 1)
    save()

    z_vec, rem, ok, dt_r = round_and_verify(
        Z_fin, out.X_half, jax.random.fold_in(key, 4242), tag="final")
    rec["final"] = dict(Z=int(Z_fin), rem=rem, verified=ok, round_s=dt_r)
    if rem != 0 and Z_fin in feasible:
        print("final rounding missed; using the search probe's assignment")
        z_vec = feasible[Z_fin]
        rec["final"]["used_probe_assignment"] = True
        rec["final"]["rem"] = 0
    np.savez_compressed(os.path.join(repo, "million_link_e2e_assignment.npz"),
                        z_vec=np.asarray(z_vec), Z=Z_fin)
    save()

    # ---- BLER at 1M (reference env.py:226-232 semantics, sparse eval) ------
    if not skip_bler:
        t0 = time.time()
        bler = env.evaluate_bler(np.asarray(z_vec)[:K], int(Z_fin))
        rec["phases_s"]["bler"] = round(time.time() - t0, 1)
        rec["bler"] = dict(mean=float(np.mean(bler)),
                           max=float(np.max(bler)),
                           frac_above_1e5=float(np.mean(bler > 1e-5)),
                           p99=float(np.quantile(bler, 0.99)))
        print(f"bler mean={rec['bler']['mean']:.3e} "
              f"max={rec['bler']['max']:.3e} "
              f"frac>1e-5={rec['bler']['frac_above_1e5']:.3f} "
              f"[{rec['phases_s']['bler']}s]")
    rec["total_s"] = round(sum(rec["phases_s"].values()), 1)
    save()
    print(f"DONE total={rec['total_s']}s -> {out_path}")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=int, default=580)
    ap.add_argument("--rho", type=float, default=75e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nit-probe", type=int, default=120)
    ap.add_argument("--eta-probe", type=float, default=0.05)
    ap.add_argument("--nit-conv", type=int, default=625)
    ap.add_argument("--eta-conv", type=float, default=0.04)
    ap.add_argument("--segment", type=int, default=5)
    ap.add_argument("--lanczos-m", type=int, default=8)
    ap.add_argument("--nattempt", type=int, default=3)
    ap.add_argument("--no-transpose", action="store_true")
    ap.add_argument("--gram", type=str, default="edge")
    ap.add_argument("--row-chunk", type=int, default=2048)
    ap.add_argument("--win", type=int, default=8)
    ap.add_argument("--skip-bler", action="store_true")
    ap.add_argument("--platform", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, a.rho, a.seed, nit_probe=a.nit_probe,
         eta_probe=a.eta_probe, nit_conv=a.nit_conv, eta_conv=a.eta_conv,
         segment=a.segment, lanczos_m=a.lanczos_m, nattempt=a.nattempt,
         store_transpose=not a.no_transpose, gram_mode=a.gram,
         row_chunk=a.row_chunk, win=a.win, skip_bler=a.skip_bler,
         out_path=a.out, platform=a.platform)
