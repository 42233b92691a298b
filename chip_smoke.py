"""Run the SIG-SDP pipeline once on a GPU and check what comes out.

    python chip_smoke.py              # one card
    python chip_smoke.py --four-gpus  # the sharded paths only, four cards

One card runs four phases, each through the package's public entry points:

1. device: the card, JAX, the native host library;
2. journal scale (K=300, dense solver): min-Z binary search, rounding,
   independent verification, BLER; then the solve at the found Z on the GPU
   and on the host CPU with the same key, compared;
3. plant scale (K=100,467, block-sparse solver, bf16 blocks): the
   tools/e2e_large.py pipeline at its defaults — min-Z search, verification,
   BLER — with every operand and the solver output asserted to be on the GPU;
4. SpMM at real width (K=100,467, D=48): the block-sparse product for S~ and
   S~^T against scipy's float64 product, plus the times of the block-128,
   block-(8,128) and ELL-gather SpMMs.

``--four-gpus`` runs only the K=100,467 solve row-sharded over four cards,
compared with the one-card solve under the same key and then rounded and
verified, and a batch of four K=300 scenarios sharded over the same cards.

Every check raises on failure, so the script exits non-zero and prints no
result.  The last line of standard output is one JSON object with the
device as JAX reports it.  One process drives the cards: run nothing else
on them meanwhile.
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

print = functools.partial(print, flush=True)

# GPU vs CPU, K=300, same key.  Every f32 product of the solve asks for
# Precision.HIGHEST (true f32, no TF32 on the GPU), so the two differ only
# in summation order and library kernels: ~1e-7 in the averaged primal,
# which the final eigen-factorization amplifies to ~1e-4 in X_half
# (measured on an H100).  ub_final is ~0.34 and X_half entries reach ~0.4,
# so these bounds sit an order of magnitude above that noise and far below
# any change that moves a decision.  X_half columns are eigenvectors,
# compared up to sign.  (With the default precision, TF32 contractions in
# the Lanczos and factorization steps gave max|d X_half| = 1.0e-2.)
TOL_UB = 1e-4
TOL_XHALF = 1e-3

# Sharded vs one-card solve: same dtypes and kernels, only the order of the
# cross-device sums differs (the same bounds as tools/sharded_large.py).
TOL_SHARD_UB = 1e-3
TOL_SHARD_XHALF = 1e-3
# Largest over smallest per-card peak in the sharded solve.
TOL_SHARD_PEAK = 1.2

# bf16 unit roundoff: an 8-bit significand rounded to nearest.
U_BF16 = 2.0 ** -8
U_F32 = 2.0 ** -24


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def _timed(fn, *args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def _leaves_on(tree, dev):
    import jax

    return all(leaf.devices() == {dev} for leaf in jax.tree.leaves(tree)
               if hasattr(leaf, "devices"))


def _sign_aligned_max_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    sgn = np.where(np.sum(a * b, axis=0) < 0, -1.0, 1.0)
    return float(np.max(np.abs(a - b * sgn)))


def phase_device():
    import jax

    from sig_sdp_mmw_tpu.native import native_available
    from sig_sdp_mmw_tpu.utils.runtime import (gpu_name_and_power_limit,
                                               require_gpu)

    devs = require_gpu()
    card = "; ".join(gpu_name_and_power_limit().splitlines())
    print(f"[device] kind={devs[0].device_kind} count={len(devs)} "
          f"jax={jax.__version__} native={native_available()}")
    print(f"[device] nvidia-smi name,power.limit: {card}")
    return devs, card


def phase_journal(dev):
    import jax

    from sig_sdp_mmw_tpu.env import WirelessEnv
    from sig_sdp_mmw_tpu.models import MMW, BinarySearchRelaxation, mmw_solve
    from sig_sdp_mmw_tpu.models.rounding import verify_assignment

    t0 = time.perf_counter()
    env = WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=7)
    state = jax.device_put(env.generate_S_Q_hmax(), dev)
    search = BinarySearchRelaxation()
    alg = MMW(nit=150, eta=0.04, seed=0)
    search.feasibility_check_alg = alg
    z_vec, Z, rem = search.run(state)
    ok, n_interf, n_asso = verify_assignment(state, z_vec)
    bler = np.asarray(env.evaluate_bler(z_vec, Z))
    print(f"[journal] K={state.K} Z={Z} rem={rem} verified={ok} "
          f"(interf={n_interf} asso={n_asso}) bler_mean={bler.mean():.3e} "
          f"bler_max={bler.max():.3e} [{time.perf_counter() - t0:.2f}s]")
    check(rem == 0, f"journal: rem={rem}")
    check(ok, f"journal: schedule not verified ({n_interf}, {n_asso})")
    check(np.all(np.isfinite(bler)), "journal: non-finite BLER")

    D_pad, rank_pad = alg._d_pad_for(state, Z)
    key = jax.random.PRNGKey(0)

    def solve(s, k):
        return mmw_solve(s, float(Z), nit=150, eta=0.04, D_pad=D_pad,
                         rank_pad=rank_pad, key=k)

    cpu = jax.devices("cpu")[0]
    out_g = jax.jit(solve)(state, key)
    out_c = jax.jit(solve)(jax.device_put(state, cpu),
                           jax.device_put(key, cpu))
    check(out_g.X_half.devices() == {dev}, "journal: GPU solve left the GPU")
    check(out_c.X_half.devices() == {cpu}, "journal: CPU solve left the CPU")
    d_ub = abs(float(out_g.ub_final) - float(out_c.ub_final))
    d_x = _sign_aligned_max_diff(out_g.X_half, out_c.X_half)
    d_avg = float(np.max(np.abs(np.asarray(out_g.X_avgd)
                                - np.asarray(out_c.X_avgd))))
    print(f"[journal] GPU vs CPU at Z={Z}: ub_gpu={float(out_g.ub_final):.6f} "
          f"|d ub_final|={d_ub:.3e} (tol {TOL_UB:g}) "
          f"max|d X_half|={d_x:.3e} (tol {TOL_XHALF:g}, up to column sign) "
          f"max|d X_avgd|={d_avg:.3e}")
    check(d_ub <= TOL_UB, f"journal: |d ub_final|={d_ub}")
    check(d_x <= TOL_XHALF, f"journal: max|d X_half|={d_x}")


def phase_plant(dev, card, cell=183):
    import jax
    import jax.numpy as jnp

    from sig_sdp_mmw_tpu.env.large import LargeEnv
    from sig_sdp_mmw_tpu.models.mmw_ell import MMWEll
    from sig_sdp_mmw_tpu.models.rounding_ell import verify_assignment_csr
    from sig_sdp_mmw_tpu.models.search import BinarySearchRelaxation

    times = {}
    t0 = time.perf_counter()
    env = LargeEnv(cell, 75e-4, seed=0)
    S, Q, h = env.generate_state_csr()
    times["generate"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ell = jax.device_put(env.generate_ell(), dev)
    jax.block_until_ready(ell)
    times["ell_build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    nit = 150
    alg = MMWEll(nit=nit, eta=0.05, use_bcsr=True, seed=0)
    alg.prepare(ell, S, Q, block=128, dtype=jnp.bfloat16,
                store_transpose=True)
    alg._bcsr = jax.device_put(alg._bcsr, dev)
    jax.block_until_ready(alg._bcsr)
    times["bcsr_build"] = time.perf_counter() - t0
    ops = alg._bcsr
    print(f"[plant] K={S.shape[0]} nnz(S)={S.nnz} Kb={ops.s_blocks.Kb} "
          f"maxblk={ops.s_blocks.bcols.shape[1]} block_bytes="
          f"{ops.s_blocks.blocks.nbytes} x2 "
          f"fill={100 * ops.nnz / ops.s_blocks.blocks.size:.3f}%")
    check(_leaves_on(ops, dev), "plant: an operand leaf is not on the GPU")

    t0 = time.perf_counter()
    search = BinarySearchRelaxation()
    search.feasibility_check_alg = alg
    z_vec, Z, rem = search.run(ell)
    times["search"] = time.perf_counter() - t0
    x_dev = alg.last_output.X_half.devices()
    check(x_dev == {dev}, f"plant: X_half lives on {x_dev}")
    check(_leaves_on(alg._bcsr, dev), "plant: operands left the GPU")
    check(rem == 0, f"plant: rem={rem}")

    t0 = time.perf_counter()
    ok, n_interf, n_asso = verify_assignment_csr(S, Q, h, z_vec)
    times["verify"] = time.perf_counter() - t0
    check(ok, f"plant: schedule not verified ({n_interf}, {n_asso})")

    t0 = time.perf_counter()
    bler = env.evaluate_bler(z_vec, int(Z))
    times["bler"] = time.perf_counter() - t0
    check(np.all(np.isfinite(bler)), "plant: non-finite BLER")

    probes = np.asarray(alg.LOGGED_NP_DATA["mmw_all_it"])
    probe_s = [round(float(t) / 1e6, 3) for t in probes[:, -1]]
    # The first probe compiles; every later one reuses its executable.
    ms_per_iter = (float(np.median(probes[1:, -1])) / 1e3 / nit
                   if len(probes) > 1 else float("nan"))
    print(f"[plant] Z={Z} rem={rem} verified={ok} probes(Z)="
          f"{[int(z) for z in probes[:, 3]]} probe_s={probe_s} "
          f"bler_mean={np.mean(bler):.3e} "
          f"frac>1e-5={np.mean(bler > 1e-5):.4f}")
    print(f"[plant] solver ms/iteration (block 128, bf16, median of probes "
          f"after the first): {ms_per_iter:.3f}  [{card}]")
    print("[plant] phase seconds: " + " ".join(
        f"{k}={v:.2f}" for k, v in times.items()) + f"  [{card}]")
    return S, Q, ell, ops


def phase_spmm(dev, card, S, Q, ell, ops, D=48):
    import jax
    import jax.numpy as jnp

    from sig_sdp_mmw_tpu.core.ell import build_st_csr
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_from_csr, bcsr_spmm
    from sig_sdp_mmw_tpu.ops.ell import ell_spmm

    St = build_st_csr(S, Q).tocsr()
    StT = St.transpose().tocsr()
    K = St.shape[0]
    V = np.random.default_rng(0).standard_normal((K, D)).astype(np.float32)
    V64 = V.astype(np.float64)
    nr = ops.s_blocks.nrows
    Vp = jax.device_put(np.pad(V, ((0, nr - K), (0, 0))), dev)
    spmm = jax.jit(bcsr_spmm)

    for name, mat, ref in (("S~", ops.s_blocks, St),
                           ("S~^T", ops.st_blocks, StT)):
        got = np.asarray(spmm(mat, Vp), np.float64)[:K]
        want = ref @ V64
        # Elementwise bound: both the block values and V are rounded to
        # bf16 (u each), the products are exact in f32 and n terms are
        # summed in f32, so |got - want| <= (2u + u^2 + n u_f32) |S||V|.
        bound = abs(ref) @ np.abs(V64)
        n = mat.bcols.shape[1] * mat.B
        tol = 2 * U_BF16 + U_BF16 ** 2 + n * U_F32
        err = np.abs(got - want)
        ratio = float(np.max(err / np.where(bound > 0, bound, 1.0)))
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        print(f"[spmm] {name} K={K} D={D}: max |d|/(|S||V|)={ratio:.3e} "
              f"(tol {tol:.3e}: bf16 values and V, f32 sums) "
              f"rel_fro={rel:.3e}")
        check(ratio <= tol, f"spmm {name}: {ratio} > {tol}")
        check(np.all(err[bound == 0] == 0), f"spmm {name}: fill outside S")

    t_b128 = _timed(spmm, ops.s_blocks, Vp)
    b8 = jax.device_put(bcsr_from_csr(St, block=(8, 128), pad_rows_to=nr,
                                      dtype=jnp.bfloat16), dev)
    t_b8 = _timed(spmm, b8, Vp)
    Ve = jax.device_put(np.pad(V, ((0, ell.Kp - K), (0, 0))), dev)
    t_ell = _timed(jax.jit(ell_spmm), ell.s_cols, ell.s_vals, Ve)
    print(f"[spmm] one S~ @ V, K={K} D={D}, median of 20: "
          f"block128_bf16={t_b128:.3f} ms "
          f"(stored {ops.s_blocks.blocks.nbytes} B) "
          f"block8x128_bf16={t_b8:.3f} ms (stored {b8.blocks.nbytes} B) "
          f"ell_gather_f32={t_ell:.3f} ms  [{card}]")


def phase_four_gpus(devs, card, cell=183):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sig_sdp_mmw_tpu.core.ell import ell_from_scipy
    from sig_sdp_mmw_tpu.env import WirelessEnv
    from sig_sdp_mmw_tpu.env.large import LargeEnv
    from sig_sdp_mmw_tpu.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_tpu.models.rounding_ell import (rounding_native_csr,
                                                     verify_assignment_csr)
    from sig_sdp_mmw_tpu.ops.bcsr import bcsr_operands_from_state
    from sig_sdp_mmw_tpu.parallel import (make_mesh, solve_scenarios_batched,
                                          stack_states)

    check(len(devs) >= 4, f"--four-gpus needs 4 GPUs, found {len(devs)}")
    mesh = make_mesh(4, batch_size=1)
    block = 128

    env = LargeEnv(cell, 75e-4, seed=0)
    S, Q, h = env.generate_state_csr()
    K = S.shape[0]
    unit = block * 4
    nr = ((K + unit - 1) // unit) * unit
    # Host (numpy) leaves, so that each card receives only its own slice:
    # built as device arrays, the whole set would first land on card 0.
    ell = ell_from_scipy(S, Q, h, pad_rows_to=nr, host=True)
    ops = bcsr_operands_from_state(S, Q, block=block, dtype=jnp.bfloat16,
                                   store_transpose=True, pad_rows_to=nr,
                                   host=True)
    lb = int(np.diff(Q.indptr).max()) + 1
    Z = float(lb + 4)
    D_pad = ((int(Z) * 2 + 15) // 16) * 16
    row_lens = (ops.s_blocks.Kb, ell.Kp, ops.s_blocks.nrows)

    def shard_leaf(x):
        # Row- and block-row-indexed arrays split over the graph axis; edge
        # vectors and maps are replicated.
        if x.ndim >= 1 and x.shape[0] in row_lens:
            spec = P("graph", *([None] * (x.ndim - 1)))
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    ops_sh = jax.tree.map(shard_leaf, ops)
    ell_sh = jax.tree.map(shard_leaf, ell)
    blocks = ops_sh.s_blocks.blocks
    per_dev = [s.data.nbytes for s in blocks.addressable_shards]
    check(per_dev == [blocks.nbytes // 4] * 4,
          f"four: S~ blocks not split in quarters: {per_dev}")
    jax.block_until_ready((ops_sh, ell_sh))
    held = [d.memory_stats()["bytes_in_use"] for d in devs[:4]]

    key = jax.random.PRNGKey(0)
    fn = jax.jit(lambda e, k, b: mmw_solve_ell(
        e, Z, nit=150, eta=0.05, D_pad=D_pad, rank_pad=D_pad, key=k,
        bcsr=b))
    t0 = time.perf_counter()
    out_sh = fn(ell_sh, key, ops_sh)
    ub_sh = float(out_sh.ub_final)
    t_sh = time.perf_counter() - t0
    check(len(out_sh.X_half.sharding.device_set) == 4,
          "four: sharded solve output is not spread over four cards")
    # Read before the one-card solve, which runs on card 0.  An SPMD
    # program holds the same on every card; staging the whole operand set
    # on card 0 would about double its peak.
    peak = [d.memory_stats()["peak_bytes_in_use"] for d in devs[:4]]
    check(max(peak) <= TOL_SHARD_PEAK * min(peak),
          f"four: per-card peaks {peak} are not balanced")

    dev0 = devs[0]
    t0 = time.perf_counter()
    out_1 = fn(jax.device_put(ell, dev0), key, jax.device_put(ops, dev0))
    ub_1 = float(out_1.ub_final)
    t_1 = time.perf_counter() - t0
    d_ub = abs(ub_sh - ub_1)
    d_x = _sign_aligned_max_diff(out_sh.X_half, out_1.X_half)
    print(f"[four] K={K} Z={Z} sharded ub={ub_sh:.6f} one-card ub={ub_1:.6f} "
          f"|d ub|={d_ub:.3e} (tol {TOL_SHARD_UB:g}) max|d X_half|={d_x:.3e} "
          f"(tol {TOL_SHARD_XHALF:g}) bytes_per_card after placement="
          f"{held} peak_bytes_per_card in the sharded solve={peak} "
          f"wall_s incl. compile: sharded={t_sh:.2f} one-card={t_1:.2f} "
          f"[{card}]")
    check(d_ub <= TOL_SHARD_UB, f"four: |d ub|={d_ub}")
    check(d_x <= TOL_SHARD_XHALF, f"four: max|d X_half|={d_x}")

    z_vec, _, rem = rounding_native_csr(int(Z), np.asarray(out_sh.X_half),
                                        S, Q, h, jax.random.PRNGKey(7),
                                        nattempt=10)
    ok, n_interf, n_asso = verify_assignment_csr(S, Q, h, z_vec)
    print(f"[four] rounding of the sharded solve: rem={rem} verified={ok} "
          f"(interf={n_interf} asso={n_asso})")
    check(rem == 0 and ok, f"four: rem={rem} verified={ok}")

    mesh4 = make_mesh(4)
    states = stack_states([
        WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=s,
                    pad_to=320).generate_S_Q_hmax() for s in range(4)])
    t0 = time.perf_counter()
    out_b = solve_scenarios_batched(states, 14.0, nit=150, eta=0.04,
                                    D_pad=32, rank_pad=32, key=key,
                                    mesh=mesh4)
    ub_b = np.asarray(out_b.ub_final)
    t_b = time.perf_counter() - t0
    check(len(out_b.X_half.sharding.device_set) == 4,
          "four: scenario batch is not spread over four cards")
    out_r = solve_scenarios_batched(jax.device_put(states, dev0), 14.0,
                                    nit=150, eta=0.04, D_pad=32, rank_pad=32,
                                    key=key)
    d_b = float(np.max(np.abs(ub_b - np.asarray(out_r.ub_final))))
    print(f"[four] 4 x K=300 scenario batch over mesh "
          f"{dict(mesh4.shape)}: ub={[f'{u:.4f}' for u in ub_b]} "
          f"|d ub| vs one card={d_b:.3e} (tol {TOL_SHARD_UB:g}) "
          f"wall_s incl. compile={t_b:.2f}")
    check(np.all(np.isfinite(ub_b)), "four: non-finite batch ub")
    check(d_b <= TOL_SHARD_UB, f"four: batch |d ub|={d_b}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    # The GPU-vs-CPU comparison needs the host CPU backend beside the GPU.
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    from sig_sdp_mmw_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    t_all = time.perf_counter()
    devs, card = phase_device()
    if args.four_gpus:
        phase_four_gpus(devs, card)
    else:
        dev = devs[0]
        phase_journal(dev)
        S, Q, ell, ops = phase_plant(dev, card)
        phase_spmm(dev, card, S, Q, ell, ops)
    print(f"[total] {time.perf_counter() - t_all:.1f}s  [{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
