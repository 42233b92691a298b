"""Profiling hooks: reference-compatible decorator + device-level tracing.

The reference wraps hot functions with ``line_profiler`` behind a global
enabler (``sim_src/util.py:91-110``).  ``line_profiler`` measures Python
lines — meaningless for compiled device code — so here:

* :func:`profile` keeps the reference's decorator surface but uses cProfile
  (host-side orchestration cost), gated by the same
  :data:`GLOBAL_PROF_ENABLER`;
* :func:`device_trace` wraps ``jax.profiler.trace`` — the way to
  see per-op device time (open the trace in TensorBoard / Perfetto);
* :func:`annotate` wraps ``jax.profiler.TraceAnnotation`` for phase markers
  that show up inside device traces (the analogue of the reference's
  ``mmw_dual``/``mmw_loss``/``mmw_expm`` timer brackets).
"""

from __future__ import annotations

import contextlib
import cProfile
import functools
import pstats
import sys


class _ProfEnabler:
    enabled = True

    def DISABLE(self):
        self.enabled = False

    def ENABLE(self):
        self.enabled = True


GLOBAL_PROF_ENABLER = _ProfEnabler()


def profile(func):
    """Reference-compatible host profiler decorator (``util.py:100-110``)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if not GLOBAL_PROF_ENABLER.enabled:
            return func(*args, **kwargs)
        prof = cProfile.Profile()
        try:
            return prof.runcall(func, *args, **kwargs)
        finally:
            pstats.Stats(prof, stream=sys.stdout).sort_stats(
                "cumulative").print_stats(25)

    return wrapper


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a device trace: ``with device_trace('/tmp/trace'): run()``."""
    import jax

    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    """Phase annotation visible in device traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)
