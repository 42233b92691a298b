"""Benchmark: MMW solver iterations/sec, journal scale (K=300) + large scale
(K~100k sparse BCSR).

The reference's headline claim is MMW wall-clock speed vs the SCS oracle
(sim_mmw_scs_iter_time.py / sim_mmw_time.py); the north-star metric
(BASELINE.json) is MMW iterations/sec at matched convergence settings.

Baseline: the reference implementation (numpy/scipy, single thread) as
measured by tools/measure_baseline.py on another host's CPU ->
baseline_measurement.json (K=300, Z=12, nit=150, eta=0.05: see that file for
the phase breakdown).  It is not re-measured here, so ``vs_baseline`` is a
ratio across two machines.  The reference cannot run at K=100k at all (dense
scipy state construction OOMs/never finishes — SURVEY §0 caps its
experiments at K~1125), so the large config reports absolute throughput.

Runs on a GPU only: it fails when JAX finds none, when the large cell
fails, or when the large solve's output is not on the GPU.  Prints the
card's name and power limit, then ONE JSON line; the headline metric is the
K=300 rate, the large-K accounting rides along under "large".
"""

import json
import os
import time

import numpy as np


def _bench_k300(jax, base):
    from sig_sdp_mmw_tpu.env import WirelessEnv
    from sig_sdp_mmw_tpu.models.mmw import mmw_solve

    cfg = base["instance"]
    NIT, ETA, Z = cfg["nit"], cfg["eta"], cfg["Z"]

    env = WirelessEnv(cell_size=cfg["cell_size"],
                      sta_density_per_1m2=cfg["rho"], seed=cfg["seed"],
                      pad_to=320)
    state = env.generate_S_Q_hmax()

    D_pad = 32  # Z * rank_radio = 24, padded to 32

    @jax.jit
    def solve(state, Z, key):
        return mmw_solve(state, Z, nit=NIT, eta=ETA, D_pad=D_pad,
                         rank_pad=D_pad, key=key)

    key = jax.random.PRNGKey(0)
    out = solve(state, float(Z), key)          # compile + warmup
    float(out.ub_final)       # scalar pull = reliable completion barrier

    times = []
    for i in range(5):
        k = jax.random.fold_in(key, i)
        t0 = time.perf_counter()
        out = solve(state, float(Z), k)
        float(out.ub_final)
        times.append(time.perf_counter() - t0)

    t = float(np.median(times))
    return NIT / t


def _bench_large(jax, cell=183, nit=30, lanczos_m=8, block=128):
    """K~100k block-sparse solve: it/s, useful GFLOP/s, streamed bytes."""
    import jax.numpy as jnp

    from sig_sdp_mmw_tpu.core.ell import ell_from_scipy
    from sig_sdp_mmw_tpu.env.large import generate_large_state_csr
    from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state

    dev = jax.devices()[0]
    S, Q, h = generate_large_state_csr(cell, 75e-4, seed=0)
    K = S.shape[0]
    ell = jax.device_put(ell_from_scipy(S, Q, h), dev)
    # store_transpose: S-tilde^T matvecs run as gather SpMMs instead of
    # scatter-adds; memory is trivial at 100k.
    ops = bcsr_operands_from_state(S, Q, block=block, dtype=jnp.bfloat16,
                                   store_transpose=True)
    ops = jax.device_put(ops, dev)
    jax.block_until_ready(ops)

    lb = int(np.diff(Q.indptr).max()) + 1
    Z = float(lb + 4)                      # the feasible region's scale
    D_pad = ((int(Z) * 2 + 15) // 16) * 16

    fn = jax.jit(lambda e, k, b: mmw_solve_ell(
        e, Z, nit=nit, eta=0.05, D_pad=D_pad, rank_pad=D_pad, key=k,
        lanczos_m=lanczos_m, bcsr=b))
    key = jax.random.PRNGKey(0)
    out = fn(ell, key, ops)
    float(out.ub_final)
    if out.X_half.devices() != {dev}:
        raise RuntimeError(f"large solve ran on {out.X_half.devices()}, "
                           f"not on the GPU")

    times = []
    for i in range(3):
        k = jax.random.fold_in(key, i)
        t0 = time.perf_counter()
        out = fn(ell, k, ops)
        float(out.ub_final)
        times.append(time.perf_counter() - t0)
    t = float(np.median(times))
    per_it = t / nit

    # expm-phase FLOP accounting per iteration: the Lanczos chain applies the
    # loss operator (one SpMM through S-tilde + one through its transpose +
    # rank-1/diag terms) lanczos_m times, plus operator applications in the
    # UB/averaging updates: (2*lanczos_m + 4) SpMM-equivalents of 2*nnz*D
    # useful FLOPs each (same accounting as tools/bench_large.py).
    nnz = int(S.nnz)
    n_spmm = 2 * lanczos_m + 4
    useful = n_spmm * 2 * nnz * D_pad
    # Performed FLOPs include the block fill (the zeros stored inside each
    # block are multiplied for real).
    performed = n_spmm * 2 * int(ops.s_blocks.blocks.size) * D_pad
    # Each SpMM-equivalent streams the full block array.
    blk_bytes = int(ops.s_blocks.blocks.size) * ops.s_blocks.blocks.dtype.itemsize
    streamed = n_spmm * blk_bytes
    return {
        "K": K,
        "nnz": nnz,
        "Z": Z,
        "D_pad": D_pad,
        "nit": nit,
        "iters_per_sec": round(nit / t, 2),
        "ms_per_iter": round(per_it * 1e3, 3),
        "useful_gflops": round(useful / per_it / 1e9, 1),
        "performed_gflops": round(performed / per_it / 1e9, 1),
        "streamed_gb_per_iter": round(streamed / 1e9, 2),
        "achieved_gbps": round(streamed / per_it / 1e9, 1),
        "device": dev.device_kind,
        "block_fill_pct": round(100 * nnz / ops.s_blocks.blocks.size, 2),
    }


def main():
    import jax

    from sig_sdp_mmw_tpu.utils.runtime import (enable_compile_cache,
                                               gpu_name_and_power_limit,
                                               require_gpu)

    enable_compile_cache()
    devs = require_gpu()
    card = gpu_name_and_power_limit()
    print(f"card: {card}")

    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, "baseline_measurement.json")) as f:
        base = json.load(f)

    iters_per_sec = _bench_k300(jax, base)
    ref = base["iters_per_sec"]
    large = _bench_large(jax)

    print(json.dumps({
        "metric": "mmw_iterations_per_sec_K300",
        "value": round(iters_per_sec, 2),
        "unit": "iter/s",
        "vs_baseline": round(iters_per_sec / ref, 2),
        "vs_baseline_is": "ratio to the numpy/scipy reference measured on "
                          "another host's CPU (baseline_measurement.json)",
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "card": card,
        "large": large,
    }))


if __name__ == "__main__":
    main()
