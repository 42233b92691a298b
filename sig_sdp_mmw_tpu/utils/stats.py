"""Instrumentation: phase timers, in-memory metric tables, debug prints.

Re-design of the reference's ``STATS_OBJECT`` mixin
(``sim_src/util.py:114-217``).  The metric *keys* and on-disk table format are
kept identical so the reference's benchmark tooling carries over:

* tables are ``{key: ndarray}`` with a 3-column header
  ``(g_step, step, unix_time)`` followed by the payload row
  (``sim_src/util.py:149-162``);
* ``save_np`` writes ``<Class>.<key>.<postfix>.txt`` CSV text files
  (``sim_src/util.py:136-147``);
* microsecond tic/tim timer pairs (``sim_src/util.py:201-217``).

Differences from the reference (deliberate, for asynchronous devices):

* timers synchronize device work — ``tim()`` calls
  ``jax.block_until_ready`` on an optional handle so a phase's time includes
  its asynchronously-dispatched XLA work;
* the timer store is a dict, not a linear-scan list;
* metric rows are buffered in Python lists and materialized on save, instead
  of ``np.vstack`` growth (which is O(n^2) in the reference).
"""

from __future__ import annotations

import os
import pprint
import time
from typing import Any, Dict, List, Optional

import numpy as np

LOGGED_NP_DATA_HEADER_SIZE = 3


def get_current_time_str() -> str:
    from datetime import datetime

    return datetime.now().strftime("%Y-%B-%d-%H-%M-%S")


class StatsObject:
    """Mixin: per-instance metric tables + µs timers + rate-limited prints."""

    DISABLE_ALL_DEBUG = False
    DEBUG_STEP = 100
    DEBUG = False
    PRINT_DIM = 5
    MOVING_AVERAGE_TIME_WINDOW = 100

    # --- lazy per-instance state -------------------------------------------------
    def _stats_init(self) -> None:
        if not hasattr(self, "_np_log"):
            self._np_log: Dict[str, List[np.ndarray]] = {}
            self._np_log_width: Dict[str, int] = {}
            self._timers: Dict[int, float] = {}
            self._ntimer = 0
            self._mavg: Dict[str, float] = {}
            self._mavg_n: Dict[str, float] = {}
            self.N_STEP = 0
            self.LOGGED_CLASS_NAME: Optional[str] = None

    # --- metric tables ------------------------------------------------------------
    def _add_np_log(self, key: str, step: int, float_row_data, g_step: int = 0) -> None:
        self._stats_init()
        row = np.squeeze(np.asarray(float_row_data, dtype=np.float64))
        assert row.ndim in (0, 1)
        row = np.atleast_1d(row)
        if key not in self._np_log:
            self._np_log[key] = []
            self._np_log_width[key] = row.size + LOGGED_NP_DATA_HEADER_SIZE
        assert row.size + LOGGED_NP_DATA_HEADER_SIZE == self._np_log_width[key]
        self._np_log[key].append(
            np.hstack((np.array([g_step, step, time.time()]), row))
        )

    @property
    def LOGGED_NP_DATA(self) -> Dict[str, np.ndarray]:
        """Materialized metric tables (reference-compatible view)."""
        self._stats_init()
        return {k: np.vstack(v) if v else np.zeros((0, self._np_log_width[k]))
                for k, v in self._np_log.items()}

    def save_np(self, path: str, postfix: str) -> None:
        os.makedirs(path, exist_ok=True)
        name = self.LOGGED_CLASS_NAME or self.__class__.__name__
        for key, tab in self.LOGGED_NP_DATA.items():
            np.savetxt(os.path.join(path, f"{name}.{key}.{postfix}.txt"), tab,
                       delimiter=",")

    # --- timers -------------------------------------------------------------------
    def _get_tic(self) -> int:
        self._stats_init()
        self._ntimer += 1
        self._timers[self._ntimer] = time.time()
        return self._ntimer

    def _get_tim(self, tic_id: int, sync: Any = None) -> float:
        """Elapsed µs since ``tic_id``; blocks on ``sync`` (a jax array/pytree)
        first so asynchronously dispatched device work is included."""
        if sync is not None:
            try:
                import jax

                jax.block_until_ready(sync)
            except Exception:
                pass
        t0 = self._timers.pop(tic_id, None)
        if t0 is None:
            raise KeyError("no timer is found.")
        return (time.time() - t0) * 1e6

    # --- moving averages ------------------------------------------------------
    def _moving_average(self, key: str, new_value: float) -> float:
        self._stats_init()
        if key not in self._mavg:
            self._mavg[key] = 0.0
            self._mavg_n[key] = 0.0
        step = min(self._mavg_n[key] + 1, self.MOVING_AVERAGE_TIME_WINDOW)
        self._mavg[key] = self._mavg[key] * (1.0 - 1.0 / step) + new_value / step
        self._mavg_n[key] += 1
        return self._mavg[key]

    # --- debug prints -----------------------------------------------------------
    def status(self) -> None:
        if self.DEBUG:
            pprint.pprint(vars(self))

    def _print(self, *args, **kwargs) -> None:
        self._stats_init()
        if self.DEBUG and not StatsObject.DISABLE_ALL_DEBUG and (
            self.N_STEP % self.DEBUG_STEP in (0, 1, 2)
        ):
            print(("%6d\t" % self.N_STEP) + " ".join(map(str, args)), **kwargs)

    def _printalltime(self, *args, **kwargs) -> None:
        self._stats_init()
        print(("%6d\t" % self.N_STEP) + ("%10s\t" % self.__class__.__name__)
              + " ".join(map(str, args)), **kwargs)

    def _debug(self, enable: bool, debug_step: int = 100) -> None:
        self.DEBUG = enable
        self.DEBUG_STEP = debug_step


# Reference-compatible alias (``from sim_src.util import STATS_OBJECT``).
STATS_OBJECT = StatsObject


# ---------------------------------------------------------------------------
# Small reference-parity helpers (sim_src/util.py:12-19, 274-293)
# ---------------------------------------------------------------------------

def p_true(probability_of_true: float) -> bool:
    return bool(np.random.random() < probability_of_true)


def db_to_ratio(a):
    return 10.0 ** (np.asarray(a) / 10.0)


def ratio_to_db(a):
    return 10.0 * np.log10(np.asarray(a))


DbToRatio = db_to_ratio
RatioToDb = ratio_to_db


def plot_a_array(arr, mavg_n: int = 20, name: str = "", script_file=None,
                 postfix: str = "", idx=None, show: bool = False,
                 save_path=None):
    """Moving-average curve plot (``sim_src/util.py:274-293``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(16, 6), dpi=80)
    data = np.convolve(np.asarray(arr), np.ones(mavg_n) / mavg_n, mode="valid")
    if idx is not None:
        plt.plot(np.asarray(idx)[: data.size], data)
    else:
        plt.plot(np.arange(1, data.size + 1), data)
    if show:
        plt.show()
    if save_path:
        parts = [name, postfix, get_current_time_str()]
        if script_file:
            parts.insert(0, os.path.splitext(os.path.basename(script_file))[0])
        fig_dir = os.path.join(save_path, "saved_figures")
        os.makedirs(fig_dir, exist_ok=True)
        fig.savefig(os.path.join(fig_dir, "-".join(p for p in parts if p)))
    plt.close(fig)
    return data
