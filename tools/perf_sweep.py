"""Perf/quality sweep of MMW solver knobs on the accelerator.

Measures per-solve wall time + final max-violation for different Lanczos
dims and matmul precisions at the bench instance (K=300, Z=12, nit=150).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from sig_sdp_mmw_tpu.env import WirelessEnv
from sig_sdp_mmw_tpu.models import mmw_solve


def timed(fn, *args, n=3):
    out = fn(*args)
    float(out.ub_final)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args)
        float(out.ub_final)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def main():
    env = WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=7,
                      pad_to=320)
    state = env.generate_S_Q_hmax()
    key = jax.random.PRNGKey(0)
    NIT, ETA, Z = 150, 0.05, 12.0

    for m in [32, 24, 16, 12, 8]:
        fn = jax.jit(lambda st, k, m=m: mmw_solve(
            st, Z, nit=NIT, eta=ETA, D_pad=32, rank_pad=32, key=k,
            lanczos_m=m))
        t, out = timed(fn, state, key)
        print(f"m={m:3d}  t={t*1e3:7.1f} ms  it/s={NIT/t:8.1f}  "
              f"ub_final={float(out.ub_final):.4f}")


if __name__ == "__main__":
    main()
