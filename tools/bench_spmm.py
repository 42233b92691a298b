"""SpMM backend shoot-out on the accelerator: XLA ELL gather vs the fused
block-ELL ``dot_general`` kernels, on genuine generated interference graphs.

Round-4 scope: the slot-serialized fori SpMM was replaced by one batched
dot_general (ops/bcsr.py).  This measures, at K~100k:

* forward SpMM across block shapes / dtypes / row_chunk;
* the transpose: stored-S̃ᵀ gather SpMM vs fused scatter-add;
* the D (sketch width) axis — streaming cost amortizes over D;
* achieved HBM GB/s per variant (the roofline coordinate).

Writes SPMM_BENCH.json.
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


def bench_one(fn, args, reps=10):
    """Median wall time of ``float(sum(fn(*args)))``.

    The benched fns end in jnp.sum, so pulling the scalar to the host is the
    completion barrier.
    """
    float(fn(*args))                      # compile + warm
    float(fn(*args))                      # absorb any deferred first-run cost
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(cells=(183,), D=64, reps=10, d_sweep=(48, 128)):
    import jax
    import jax.numpy as jnp

    from sig_sdp_mmw_tpu.core.ell import build_st_csr, ell_from_scipy
    from sig_sdp_mmw_tpu.env.large import generate_large_state_csr
    from sig_sdp_mmw_tpu.ops.bcsr import (bcsr_from_csr, bcsr_spmm,
                                          bcsr_spmm_transpose)
    from sig_sdp_mmw_tpu.ops.ell import ell_spmm

    recs = []
    for cell in cells:
        S, Q, h = generate_large_state_csr(cell, 75e-4, seed=0)
        K = S.shape[0]
        ell = ell_from_scipy(S, Q, h)
        St = build_st_csr(S, Q)
        StT = St.transpose().tocsr()
        nnz = St.nnz
        print(f"K={K} nnz(St)={nnz} degS={ell.s_cols.shape[1]} Kp={ell.Kp}")

        V = jax.random.normal(jax.random.PRNGKey(0), (ell.Kp, D), jnp.float32)
        ell = jax.device_put(ell)
        V = jax.device_put(V)
        jax.block_until_ready(V)

        rec = {"K": K, "Kp": ell.Kp, "nnz": int(nnz), "D": D, "ms": {},
               "gbps": {}}
        rec["gflops_useful"] = round(2 * nnz * D / 1e9, 3)

        f_xla = jax.jit(lambda c, v, x: jnp.sum(ell_spmm(c, v, x)))
        t = bench_one(f_xla, (ell.s_cols, ell.s_vals, V), reps)
        rec["ms"]["ell_xla"] = round(t * 1e3, 3)

        def add(tag, t, nbytes):
            rec["ms"][tag] = round(t * 1e3, 3)
            rec["gbps"][tag] = round(nbytes / t / 1e9, 1)
            print(f"  {tag}: {rec['ms'][tag]} ms, {rec['gbps'][tag]} GB/s")

        for blk, dt, tag in (
            ((8, 128), jnp.float32, "f8x128_f32"),
            ((128, 128), jnp.float32, "f128_f32"),
            ((128, 128), jnp.bfloat16, "f128_bf16"),
            ((64, 64), jnp.bfloat16, "f64_bf16"),
            ((64, 128), jnp.bfloat16, "f64x128_bf16"),
        ):
            bell = jax.device_put(bcsr_from_csr(St, block=blk, dtype=dt))
            nr = bell.nrows
            Vp = jnp.pad(V, ((0, nr - ell.Kp), (0, 0))) if nr > ell.Kp else V
            nbytes = bell.blocks.size * bell.blocks.dtype.itemsize
            f_b = jax.jit(lambda b, v: jnp.sum(bcsr_spmm(b, v)))
            add(tag, bench_one(f_b, (bell, Vp), reps), nbytes)
            if blk == (128, 128) and dt == jnp.bfloat16:
                # CHAINED x16: one dispatch, 16 dependent applications —
                # amortizes the per-call dispatch floor included in every
                # single-apply row above.
                NCH = 16

                def chain(b, v):
                    def step(u, _):
                        u = bcsr_spmm(b, u)
                        return u * (1.0 / (jnp.max(jnp.abs(u)) + 1.0)), None
                    u, _ = jax.lax.scan(step, v, None, length=NCH)
                    return u
                f_ch = jax.jit(lambda b, v: jnp.sum(chain(b, v)))
                t_ch = bench_one(f_ch, (bell, Vp), reps)
                rec["ms"][tag + "_chain16_per_apply"] = round(
                    t_ch * 1e3 / NCH, 3)
                rec["gbps"][tag + "_chain16_per_apply"] = round(
                    nbytes * NCH / t_ch / 1e9, 1)
                print(f"  {tag}_chain16: {t_ch*1e3:.1f} ms total, "
                      f"{t_ch*1e3/NCH:.2f} ms/apply, "
                      f"{nbytes*NCH/t_ch/1e9:.0f} GB/s")
                # chunked variant + transpose pair on the same operands
                f_c = jax.jit(lambda b, v: jnp.sum(
                    bcsr_spmm(b, v, row_chunk=2048)))
                add(tag + "_c2048", bench_one(f_c, (bell, Vp), reps), nbytes)
                f_t = jax.jit(lambda b, v: jnp.sum(
                    bcsr_spmm_transpose(b.bcols, b.blocks, v)))
                add(tag + "_Tscatter", bench_one(f_t, (bell, Vp), reps),
                    nbytes)
                bellT = jax.device_put(bcsr_from_csr(StT, block=blk, dtype=dt,
                                                     pad_rows_to=nr))
                f_tg = jax.jit(lambda b, v: jnp.sum(bcsr_spmm(b, v)))
                add(tag + "_Tstored", bench_one(f_tg, (bellT, Vp), reps),
                    bellT.blocks.size * 2)
                # D sweep on the forward kernel
                for Ds in d_sweep:
                    Vs = jnp.pad(V[:, :1], ((0, nr - ell.Kp), (0, Ds - 1)))
                    f_d = jax.jit(lambda b, v: jnp.sum(bcsr_spmm(b, v)))
                    add(f"{tag}_D{Ds}", bench_one(f_d, (bell, Vs), reps),
                        nbytes)

        print(json.dumps(rec))
        recs.append(rec)

    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "SPMM_BENCH.json")
    with open(out, "w") as f:
        json.dump({"device": str(jax.devices()[0]).split(":")[0],
                   "results": recs,
                   "notes": ["fused single-dot_general kernels (r4); "
                             "see ops/bcsr.py"]}, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, nargs="*", default=[183])
    ap.add_argument("--D", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    main(tuple(a.cells), a.D, a.reps)
