"""Test harness config: force CPU backend with an 8-device virtual mesh so
sharding tests run without accelerator hardware (SURVEY.md §4.5
pattern)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "true"

# jax may have been imported already (before this conftest), in
# which case the env vars above are ignored; the config API still works as
# long as the backend has not been initialized yet.
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_num_cpu_devices", 8)
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import numpy as np
import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="session")
def env_small():
    return dict(np.load(FIXTURES / "env_small.npz"))


@pytest.fixture(scope="session")
def env_mid():
    return dict(np.load(FIXTURES / "env_mid.npz"))


@pytest.fixture(scope="session")
def mmw_small():
    return dict(np.load(FIXTURES / "mmw_small.npz"))
