"""Process set-up shared by the entry points that run on an accelerator.

* :func:`enable_compile_cache` — JAX's persistent compilation cache at a
  fixed path, so repeated runs of the same program skip XLA compilation;
* :func:`require_gpu` — the device check of every measurement path: a run
  that finds no GPU fails instead of silently timing the CPU;
* :func:`gpu_name_and_power_limit` — the card's name and power limit as
  ``nvidia-smi`` reports them, printed beside every number a run reports.
"""

from __future__ import annotations

import os
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    path is set here.  Otherwise the cache lives at ``<repo>/.jax_cache``
    (listed in ``.gitignore``); the path is fixed because it is part of the
    cache key."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """Return ``jax.devices()`` if the default backend is a GPU; raise
    RuntimeError otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {devs[0].platform} "
            f"({devs[0].device_kind})")
    return devs


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one card per
    line.  Raises if ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
