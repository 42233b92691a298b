"""Diagnose MMW-infeasible-at-oracle-Z disagreements (VERDICT r4 task 6).

For every seed where MMW failed to round feasibly at the oracle's min-Z
(`oracle_z_run` CSVs), attribute the disagreement:

* ORACLE OPTIMISM — the finite-budget ADMM probe called Z feasible but a
  higher-budget probe (4x iterations) at the same Z disagrees;
* ROUNDING VARIANCE — a longer MMW solve (600 it) with a larger attempt
  budget (50) rounds feasibly after all;
* GENUINE GAP — neither: the relaxation is feasible but MMW's finite-rank
  factor does not round at this Z within any tried budget.

Appends the per-seed attributions to ORACLE_Z.md.
"""

import csv
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if "--accelerator" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import numpy as np

print = functools.partial(print, flush=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(path, name):
    rows = {}
    with open(os.path.join(path, name)) as f:
        for r in csv.reader(f):
            vals = [float(x) for x in r]
            rows[int(vals[1])] = (int(vals[2]), int(vals[3]))
    return rows


def main(run_dir=None, cell=10, tag="75"):
    run_dir = run_dir or os.path.join(REPO, "oracle_z_run")
    scs = load(run_dir, f"scs-{cell}-{tag}")
    mmw = load(run_dir, f"mmw150-{cell}-{tag}")
    bad = sorted(s for s in set(scs) & set(mmw)
                 if scs[s][1] == 0 and mmw[s][1] != 0)
    print(f"disagreeing seeds: {bad}")
    if not bad:
        return []

    from sig_sdp_mmw_tpu.env import WirelessEnv
    from sig_sdp_mmw_tpu.models import ADMMSDPSolver, MMW

    out = []
    for seed in bad:
        Z = scs[seed][0]
        e = WirelessEnv(cell_size=cell, sta_density_per_1m2=75e-4,
                        seed=seed)
        st = e.generate_S_Q_hmax()

        # (a) higher-budget oracle at the same Z
        oracle = ADMMSDPSolver(nit=2000)
        ok_o, gX_o = oracle.run_with_state(0, Z, st)
        _, _, rem_o = oracle.rounding(Z, gX_o, st, nattempt=20)

        # (b) longer MMW + larger attempt budget
        mm = MMW(nit=600, eta=0.04, seed=seed)
        _, gX_m = mm.run_with_state(0, Z, st)
        _, _, rem_m = mm.rounding(Z, gX_m, st, nattempt=50)

        if rem_m == 0:
            verdict = "rounding variance (feasible with nit=600/50 attempts)"
        elif rem_o != 0:
            verdict = "oracle optimism (4x-budget oracle also fails to round)"
        else:
            verdict = "genuine gap (oracle rounds, MMW does not at any budget)"
        rec = dict(seed=seed, Z=Z, rem_oracle_hi=int(rem_o),
                   rem_mmw_hi=int(rem_m), verdict=verdict)
        print(rec)
        out.append(rec)

    md = os.path.join(REPO, "ORACLE_Z.md")
    with open(md, "a") as f:
        f.write("\n## Disagreement diagnosis (tools/oracle_z_diagnose.py)\n\n")
        for r in out:
            f.write(f"- seed {r['seed']} (Z={r['Z']}): {r['verdict']} "
                    f"[hi-budget oracle rem={r['rem_oracle_hi']}, "
                    f"MMW-600/50 rem={r['rem_mmw_hi']}]\n")
    print("appended to ORACLE_Z.md")
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
