"""End-to-end large-K pipeline on one accelerator (BASELINE.json config 4).

Runs the complete reference contract — state generation -> binary search over
Z (sparse MMW feasibility probes) -> randomized rounding -> independent
feasibility verification -> BLER evaluation — entirely on the sparse path
(EllState + optional BCSR block operands), i.e. without ever materializing a
[K, K] matrix.  Reference semantics per phase:

* bounds + search:   sim_src/alg/binary_search_relaxation.py:13-72
* MMW feasibility:   sim_src/alg/mmw.py:44-222
* greedy rounding:   sim_src/alg/sdp_solver.py:27-107
* verification:      the rounding's own explicit checks, re-run independently
* BLER evaluation:   sim_src/env/env.py:198-232 (sparse truncation + tail)

Writes a JSON record (default E2E_LARGE.json at the repo root) with per-phase
wall times and the end metrics, plus the assignment as an .npz beside it.
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


def main(cell=183, rho=75e-4, seed=0, nit=150, eta=0.05, nattempt=10,
         block=128, out_path=None, use_bcsr=True, d_pad=None, platform=None,
         search="binary", wave=4, row_chunk=None, wave_segment=None,
         bf16=True):
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)

    from sig_sdp_mmw_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]

    from sig_sdp_mmw_tpu.env.large import LargeEnv
    from sig_sdp_mmw_tpu.models.mmw_ell import MMWEll
    from sig_sdp_mmw_tpu.models.rounding_ell import verify_assignment_csr
    from sig_sdp_mmw_tpu.models.search import BinarySearchRelaxation

    rec = {"config": {"cell": cell, "rho": rho, "seed": seed, "nit": nit,
                      "eta": eta, "nattempt": nattempt, "block": block,
                      "use_bcsr": use_bcsr, "bf16_blocks": bf16},
           "device": {"platform": dev.platform, "kind": dev.device_kind},
           "phases_s": {}}

    t0 = time.time()
    env = LargeEnv(cell, rho, seed=seed)
    S, Q, h = env.generate_state_csr()
    K = S.shape[0]
    rec["K"] = K
    rec["nnz_S"] = int(S.nnz)
    rec["nnz_Q"] = int(Q.nnz)
    rec["phases_s"]["generate"] = round(time.time() - t0, 2)
    print(f"generate: K={K} nnz(S)={S.nnz} nnz(Q)={Q.nnz} "
          f"[{rec['phases_s']['generate']}s]")

    t0 = time.time()
    ell = jax.device_put(env.generate_ell(), dev)
    jax.block_until_ready(ell)
    rec["phases_s"]["ell_build"] = round(time.time() - t0, 2)
    print(f"ell build: degS={ell.s_cols.shape[1]} E_pad={ell.E_pad} "
          f"Kp={ell.Kp} [{rec['phases_s']['ell_build']}s]")

    alg = MMWEll(nit=nit, eta=eta, use_bcsr=use_bcsr, nattempt=nattempt,
                 seed=seed)
    if use_bcsr:
        import jax.numpy as jnp

        t0 = time.time()
        # bf16 blocks + stored transpose: halves the per-apply HBM stream
        # and turns the S-tilde^T matvec into a gather SpMM (value noise
        # ~0.4%/entry, inside MMW's first-order tolerance — validated in
        # tests/test_ell.py lean-mode equality).
        bkw = dict(dtype=jnp.bfloat16, store_transpose=True) if bf16 else {}
        alg.prepare(ell, S, Q, block=block, **bkw)
        alg._bcsr = jax.device_put(alg._bcsr, dev)
        jax.block_until_ready(alg._bcsr)
        rec["phases_s"]["bcsr_build"] = round(time.time() - t0, 2)
        print(f"bcsr build: Kb={alg._bcsr.s_blocks.Kb} "
              f"[{rec['phases_s']['bcsr_build']}s]")

    bs = BinarySearchRelaxation()
    bs.feasibility_check_alg = alg

    t0 = time.time()
    lb, ub = bs.set_bounds(ell)
    rec["lb"], rec["ub"] = lb, ub
    rec["phases_s"]["bounds"] = round(time.time() - t0, 2)
    print(f"bounds: lb={lb} ub={ub} [{rec['phases_s']['bounds']}s]")

    if d_pad is not None:
        # Cap the sketch width: D = Z*rank_radio columns are active per probe
        # (mmw.py:180); the window upper bound would over-pad.
        alg._d_pad_for = lambda e, Z: (d_pad, min(d_pad, e.Kp - 1))

    t0 = time.time()
    if search == "speculative":
        from sig_sdp_mmw_tpu.parallel import ParallelProbeSearchEll

        pp = ParallelProbeSearchEll(nit=nit, eta=eta, nattempt=nattempt,
                                    seed=seed, wave=wave, use_bcsr=use_bcsr,
                                    spmm_row_chunk=row_chunk,
                                    d_pad_cap=d_pad,
                                    wave_segment=wave_segment)
        pp._bcsr = alg._bcsr if use_bcsr else None   # reuse device operands
        z_vec, Z_fin, rem = pp.run(ell)
        rec["phases_s"]["search"] = round(time.time() - t0, 2)
        row = np.asarray(pp.LOGGED_NP_DATA["pp_search"])[-1]
        rec["n_waves"] = int(row[-2])
        rec["search_mode"] = f"speculative(wave={wave})"
    else:
        z_vec, Z_fin, rem = bs.run(ell)
        rec["phases_s"]["search"] = round(time.time() - t0, 2)
        probes = np.asarray(alg.LOGGED_NP_DATA["mmw_all_it"])
        rec["n_probes"] = int(probes.shape[0])
        rec["solve_us_per_probe"] = [float(x) for x in probes[:, -1]]
        rec["search_mode"] = "binary"
    rec["Z_fin"] = int(Z_fin)
    rec["remainder"] = int(rem)
    print(f"search[{rec['search_mode']}]: Z={Z_fin} rem={rem} "
          f"[{rec['phases_s']['search']}s]")

    t0 = time.time()
    # Host-CSR verifier: independent of the device-side state.
    ok, n_interf, n_asso = verify_assignment_csr(S, Q, h, z_vec)
    rec["phases_s"]["verify"] = round(time.time() - t0, 2)
    rec["verified_feasible"] = bool(ok)
    rec["n_interf_vio"] = int(n_interf)
    rec["n_asso_vio"] = int(n_asso)
    print(f"verify: ok={ok} interf_vio={n_interf} asso_vio={n_asso} "
          f"[{rec['phases_s']['verify']}s]")

    t0 = time.time()
    bler = env.evaluate_bler(z_vec, int(Z_fin))
    rec["phases_s"]["bler_eval"] = round(time.time() - t0, 2)
    rec["bler_mean"] = float(np.mean(bler))
    rec["bler_max"] = float(np.max(bler))
    rec["bler_frac_above_1e-5"] = float(np.mean(bler > 1e-5))
    print(f"bler: mean={rec['bler_mean']:.3e} max={rec['bler_max']:.3e} "
          f"frac>1e-5={rec['bler_frac_above_1e-5']:.4f} "
          f"[{rec['phases_s']['bler_eval']}s]")

    # Tail decomposition (why a verified-feasible assignment still has users
    # above the 1e-5 target): the solver enforces the THRESHOLDED graph
    # exactly — every rx ratio below min_s_n_ratio is dropped from S by
    # design (reference env.py:151) — while the evaluation charges the full
    # channel.  Re-evaluate on the channel the solver constrained (exact
    # terms above min_s_n_ratio, no mean-field far tail): users that pass
    # there but fail the full evaluation are thresholding physics
    # (accumulated sub-threshold interference), not solver error.
    # CONSERVATIVE: this in-graph channel keeps every same-slot pair inside
    # the cutoff radius, while the solver graph additionally drops pairs
    # with rxpr < min_s_n_ratio (large.py) — so it OVERCOUNTS in-graph
    # interference and the sub-threshold-only fraction below is a lower
    # bound on the thresholding contribution.
    t0 = time.time()
    bler_g = env.evaluate_bler(z_vec, int(Z_fin),
                               eval_min_ratio=env.params.min_s_n_ratio,
                               tail_correction=False)
    rec["tail_decomposition"] = {
        "in_graph_min_ratio": env.params.min_s_n_ratio,
        "note": "in-graph channel is conservative (radius ball, not the "
                "per-pair threshold the solver saw); subthreshold_only is "
                "a lower bound",
        "frac_above_1e-5_in_graph_channel": float(np.mean(bler_g > 1e-5)),
        "frac_above_1e-5_full_channel": rec["bler_frac_above_1e-5"],
        "frac_above_1e-5_from_subthreshold_only":
            float(np.mean((bler > 1e-5) & (bler_g <= 1e-5))),
    }
    rec["phases_s"]["tail_decomp"] = round(time.time() - t0, 2)
    print(f"tail decomposition: {rec['tail_decomposition']} "
          f"[{rec['phases_s']['tail_decomp']}s]")

    # Heuristic baselines at the SAME Z (sim_all_bler protocol at scale):
    # the only other methods that run at 100k links.  Gives the MMW BLER
    # numbers a comparison point (VERDICT r2 missing #4).
    from sig_sdp_mmw_tpu.models.heuristics_ell import (
        MAX_GAIN_ELL, MAX_RAND_ELL)

    Z_pad_h = ((int(Z_fin) + 15) // 16) * 16
    for name, cls in (("mgain", MAX_GAIN_ELL), ("mrand", MAX_RAND_ELL)):
        t0 = time.time()
        z_h, _, rem_h = cls.run(int(Z_fin), ell, Z_pad=Z_pad_h)
        wall = round(time.time() - t0, 2)
        ok_h, ni_h, na_h = verify_assignment_csr(S, Q, h, z_h)
        bler_h = env.evaluate_bler(z_h, int(Z_fin))
        rec[name] = {
            "rem": int(rem_h), "verified_feasible": bool(ok_h),
            "n_interf_vio": int(ni_h), "n_asso_vio": int(na_h),
            "bler_mean": float(np.mean(bler_h)),
            "bler_max": float(np.max(bler_h)),
            "bler_frac_above_1e-5": float(np.mean(bler_h > 1e-5)),
            "wall_s": wall,
        }
        print(f"{name}@Z={int(Z_fin)}: rem={rem_h} ok={ok_h} "
              f"bler mean={rec[name]['bler_mean']:.3e} "
              f"max={rec[name]['bler_max']:.3e} "
              f"frac>1e-5={rec[name]['bler_frac_above_1e-5']:.4f} "
              f"[{wall}s]")
        rec["phases_s"][f"heur_{name}"] = wall

    rec["total_s"] = round(sum(rec["phases_s"].values()), 2)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_path = out_path or os.path.join(repo_root, "E2E_LARGE.json")
    # Keep the assignment npz paired with its JSON: same directory + stem,
    # so a custom --out run never overwrites the checked-in default pair.
    npz_path = os.path.splitext(out_path)[0] + "_assignment.npz" \
        if out_path != os.path.join(repo_root, "E2E_LARGE.json") \
        else os.path.join(repo_root, "e2e_large_assignment.npz")
    np.savez_compressed(npz_path, z_vec=np.asarray(z_vec), Z=int(Z_fin),
                        cell=cell, seed=seed)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out_path} (total {rec['total_s']}s)")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=int, default=183)
    ap.add_argument("--rho", type=float, default=75e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nit", type=int, default=150)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--nattempt", type=int, default=10)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--no-bcsr", action="store_true")
    ap.add_argument("--d-pad", type=int, default=None)
    ap.add_argument("--platform", type=str, default=None,
                    help="jax platform override (e.g. cpu)")
    ap.add_argument("--search", type=str, default="binary",
                    choices=("binary", "speculative"))
    ap.add_argument("--wave", type=int, default=4)
    ap.add_argument("--wave-segment", type=int, default=None)
    ap.add_argument("--f32-blocks", action="store_true",
                    help="store BCSR blocks in f32 (default bfloat16)")
    ap.add_argument("--row-chunk", type=int, default=None)
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args()
    main(a.cell, a.rho, a.seed, a.nit, a.eta, a.nattempt, a.block, a.out,
         use_bcsr=not a.no_bcsr, d_pad=a.d_pad, platform=a.platform,
         search=a.search, wave=a.wave, row_chunk=a.row_chunk,
         wave_segment=a.wave_segment, bf16=not a.f32_blocks)
