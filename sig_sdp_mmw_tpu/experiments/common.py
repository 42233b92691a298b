"""Shared experiment-harness machinery.

Replicates the conventions every reference sim script shares
(SURVEY §2.5): a timestamped ``<script>-<time>-ail`` output dir, one CSV file
per metric name (``CSV_WRITER_OBJECT``), metric names like
``mmw-<cell>-<rho*1e4>``, nested cell×seed sweeps.  Adds a ``--smoke`` mode
(tiny sweep, used by tests) and explicit platform control.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np


def experiment_args(description: str, **extra_defaults):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--repeat", type=int, default=extra_defaults.pop("repeat", 100))
    p.add_argument("--rho", type=float, default=extra_defaults.pop("rho", 75e-4))
    p.add_argument("--cells", type=int, nargs="*",
                   default=extra_defaults.pop("cells", list(range(5, 16))))
    p.add_argument("--platform", type=str, default=None,
                   help="cpu | leave unset for the default accelerator")
    p.add_argument("--smoke", action="store_true",
                   help="tiny sweep for CI: 1 seed, small cells")
    p.add_argument("--out", type=str, default=None)
    for k, v in extra_defaults.items():
        p.add_argument(f"--{k}", type=type(v), default=v)
    return p


def setup(args):
    """Apply the platform choice through the config API (it also works when
    jax was imported before the environment variables could be read), turn
    on the persistent compilation cache, and shrink sweeps in smoke mode."""
    import jax

    from sig_sdp_mmw_tpu.utils.runtime import enable_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    if args.smoke:
        args.repeat = 1
        args.cells = [c for c in args.cells if c <= 5] or [5]
    np.set_printoptions(threshold=10, linewidth=1000)


def make_log(script_file: str, out: Optional[str] = None):
    from sig_sdp_mmw_tpu.utils.logging import CsvWriter, get_log_path_for_sim_script

    path = out or get_log_path_for_sim_script(script_file)
    print(path)
    return CsvWriter(path=path), path
