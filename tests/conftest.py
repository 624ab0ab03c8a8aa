"""Test environment: force the CPU backend with 8 virtual devices so the
sharding logic is exercised without accelerator hardware (SURVEY.md
section 4, multi-host-without-a-cluster).

HQ_GPU_TESTS=1 keeps the GPU instead, for the `gpu` hardware tier:

    HQ_GPU_TESTS=1 python -m pytest -m gpu tests/test_gpu_hw.py -q
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("HQ_GPU_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: hardware-tier test; runs only on a GPU "
        "(HQ_GPU_TESTS=1 python -m pytest -m gpu tests/test_gpu_hw.py), "
        "skipped elsewhere",
    )


@pytest.fixture(autouse=True)
def _gpu_tier(request):
    """Skip `gpu`-marked tests off a GPU. Decided per test, never while
    modules are imported or collected, so every xdist worker collects the
    same tests."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip(
            "GPU hardware tier (HQ_GPU_TESTS=1 python -m pytest -m gpu "
            "tests/test_gpu_hw.py on a GPU)"
        )


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
