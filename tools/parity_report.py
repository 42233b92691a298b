"""Statistical parity report: reference pipeline vs this pipeline.

Runs BOTH full pipelines (scenario -> binary search + MMW -> rounding ->
BLER evaluation) across an ensemble of seeds and compares the distributions
of the end metrics (found Z, feasibility, mean/max BLER).  The RNG streams
differ by construction, so the comparison is ensemble-statistical — exactly
the reference's own cross-check methodology (SURVEY §4, gate 3; protocol of
``sim_script/journal_version/sim_all_bler.py:30-34``: 100 seeds per cell).

The two sides can run as separate processes (the reference is scipy/CPU;
ours runs on whatever platform is selected), each dumping raw rows to JSON:

    python tools/parity_report.py --side ref  --seeds 100 --cells 5 10 15 \
        --out parity_rows_ref.json
    python tools/parity_report.py --side ours --seeds 100 --cells 5 10 15 \
        --platform gpu --out parity_rows_ours.json
    python tools/parity_report.py --report parity_rows_ref.json \
        parity_rows_ours.json            # writes PARITY.md
"""

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

RHO = 75e-4


def run_reference(cells, seeds, nit, eta):
    from make_golden_fixtures import _install_stubs

    _install_stubs()
    sys.path.insert(0, "/root/reference")
    from sim_src.env.env import env as RefEnv
    from sim_src.alg.mmw import mmw as RefMMW
    from sim_src.alg.binary_search_relaxation import binary_search_relaxation

    rows = []
    for cell in cells:
        for seed in seeds:
            e = RefEnv(cell_size=cell, sta_density_per_1m2=RHO, seed=seed)
            bs = binary_search_relaxation()
            alg = RefMMW(nit=nit, eta=eta)
            bs.feasibility_check_alg = alg
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                z, Z, rem = bs.run(e.generate_S_Q_hmax())
            wall = time.time() - t0
            bler = e.evaluate_bler(z, Z)
            rows.append(dict(cell=cell, seed=seed, Z=int(Z), rem=int(rem),
                             bler_mean=float(bler.mean()),
                             bler_max=float(bler.max()), wall_s=wall))
            print(f"ref cell={cell} seed={seed} Z={Z} rem={rem} "
                  f"{wall:.1f}s", flush=True)
    return rows


def run_ours(cells, seeds, nit, eta, platform):
    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from sig_sdp_mmw_tpu.env import WirelessEnv
    from sig_sdp_mmw_tpu.models import MMW, BinarySearchRelaxation

    rows = []
    for cell in cells:
        for seed in seeds:
            e = WirelessEnv(cell_size=cell, sta_density_per_1m2=RHO,
                            seed=seed)
            bs = BinarySearchRelaxation()
            alg = MMW(nit=nit, eta=eta, seed=seed)
            bs.feasibility_check_alg = alg
            t0 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                z, Z, rem = bs.run(e.generate_S_Q_hmax())
            wall = time.time() - t0
            bler = e.evaluate_bler(z, Z)
            rows.append(dict(cell=cell, seed=seed, Z=int(Z), rem=int(rem),
                             bler_mean=float(bler.mean()),
                             bler_max=float(bler.max()), wall_s=wall))
            print(f"ours cell={cell} seed={seed} Z={Z} rem={rem} "
                  f"{wall:.1f}s", flush=True)
    return rows


def summarize(rows, cell):
    sel = [r for r in rows if r["cell"] == cell]
    Z = np.asarray([r["Z"] for r in sel], float)
    rem = np.asarray([r["rem"] for r in sel], float)
    bm = np.asarray([r["bler_mean"] for r in sel], float)
    bx = np.asarray([r["bler_max"] for r in sel], float)
    return dict(n=len(sel), Z_mean=Z.mean(), Z_std=Z.std(),
                Z_med=float(np.median(Z)),
                feas_rate=float((rem == 0).mean()),
                bler_mean=bm.mean(), bler_max_med=float(np.median(bx)),
                Z=Z)


def write_report(ref_rows, ours_rows, meta, path):
    from scipy import stats as sps

    cells = sorted({r["cell"] for r in ref_rows})
    lines = [
        "# PARITY — reference vs this pipeline (ensemble statistics)",
        "",
        f"{meta['seeds']} seeds per cell size, rho={RHO}, MMW "
        f"nit={meta['nit']}, eta={meta['eta']}; both pipelines end-to-end "
        "(scenario -> binary search + MMW -> rounding -> BLER).",
        f"Reference runs scipy on CPU; ours runs on "
        f"**{meta['ours_platform']}**.  Different RNG streams by "
        "construction => distributions compared, not trajectories "
        "(tests/test_mmw.py pins trajectory-level parity on shared "
        "fixtures).  Protocol: `sim_all_bler.py:30-34` (100 seeds/cell).",
        "",
        "| cell | K | pipeline | Z (mean±std) | Z med | feasible | "
        "mean BLER | median max-BLER | MWU p(Z) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for cell in cells:
        K = 3 * cell * cell
        sr = summarize(ref_rows, cell)
        so = summarize(ours_rows, cell)
        # Mann-Whitney U on the found-Z distributions: parity = failure to
        # reject at alpha=0.01 OR ours stochastically lower (better).
        try:
            p = float(sps.mannwhitneyu(so["Z"], sr["Z"],
                                       alternative="greater").pvalue)
        except ValueError:
            p = 1.0
        for name, s in (("reference", sr), ("ours", so)):
            pv = f"{p:.3f}" if name == "ours" else ""
            lines.append(
                f"| {cell} | {K} | {name} | {s['Z_mean']:.2f}±{s['Z_std']:.2f}"
                f" | {s['Z_med']:.1f} | {s['feas_rate']*100:.0f}% "
                f"| {s['bler_mean']:.2e} | {s['bler_max_med']:.2e} | {pv} |")
    lines += [
        "",
        "MWU p(Z) = one-sided Mann-Whitney U p-value for 'ours finds LARGER "
        "Z than reference'; p > 0.01 means ours is not statistically worse "
        "at the 1% level (smaller Z is better).",
        "",
        "Generated by tools/parity_report.py",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=["ref", "ours"], default=None)
    ap.add_argument("--report", nargs=2, metavar=("REF_JSON", "OURS_JSON"),
                    default=None)
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--cells", type=int, nargs="*", default=[5, 10, 15])
    ap.add_argument("--nit", type=int, default=150)
    ap.add_argument("--eta", type=float, default=0.04)
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.report:
        ref = json.load(open(args.report[0]))
        ours = json.load(open(args.report[1]))
        meta = dict(seeds=ref["meta"]["seeds"], nit=ref["meta"]["nit"],
                    eta=ref["meta"]["eta"],
                    ours_platform=ours["meta"].get("platform", "cpu"))
        write_report(ref["rows"], ours["rows"], meta,
                     os.path.join(REPO, "PARITY.md"))
        return

    seeds = range(args.seeds)
    meta = dict(seeds=args.seeds, cells=args.cells, nit=args.nit,
                eta=args.eta, platform=args.platform)
    if args.side == "ref":
        rows = run_reference(args.cells, seeds, args.nit, args.eta)
    else:
        rows = run_ours(args.cells, seeds, args.nit, args.eta, args.platform)
    out = args.out or f"parity_rows_{args.side}.json"
    with open(out, "w") as f:
        json.dump(dict(meta=meta, rows=rows), f)
    print(f"wrote {out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
