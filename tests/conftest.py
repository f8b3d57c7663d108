"""Test configuration: force the CPU backend with 8 virtual devices, so the
sharding tests run without accelerators (SURVEY.md par.4: multi-host tests
on a single host).

The on-card checks (compiled kernels against their references, the main
paths at real widths) live in chip_smoke.py, not here: this suite always
runs on the CPU backend, with Pallas kernels in interpret mode.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

from libyafaray_tpu.utils.cache import setup_compile_cache

# the sharded/grad graphs take minutes to compile; cached they load in
# seconds
setup_compile_cache(min_compile_secs=2.0)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)

