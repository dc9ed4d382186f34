"""Test env: CPU with 8 virtual devices, set BEFORE jax initializes.

SURVEY.md §4.6: mesh/sharding tests run against
--xla_force_host_platform_device_count=8 fake CPU devices. Tests that need
the card carry the `gpu` marker; the `_gpu_only` fixture skips them unless
JAX's default device is a GPU. To run them on a GPU machine:

    NBLDPC_TESTS_ON_DEVICE=1 python -m pytest tests/ -m gpu

NBLDPC_TESTS_ON_DEVICE=1 leaves JAX's platform as the machine sets it.
"""

import os

ON_DEVICE = os.environ.get("NBLDPC_TESTS_ON_DEVICE") == "1"

if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if not ON_DEVICE:
    # jax may already be imported (e.g. by a plugin), in which case the env
    # var above came too late; no backend is initialized yet, so the config
    # update still applies.
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a `gpu`-marked test unless JAX's default device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with NBLDPC_TESTS_ON_DEVICE=1 "
                    "on a GPU machine)")


@pytest.fixture(scope="session")
def small_codes():
    """Tiny + small codes used across tests, built once."""
    from nbldpc_tpu.codegen import make_peg_code

    return {
        "gf4_tiny": make_peg_code(12, 6, 4, dv=2, seed=7),
        "gf16_tiny": make_peg_code(16, 8, 16, dv=2, seed=7),
        "gf4_n96": make_peg_code(96, 48, 4, dv=2, seed=1),
        # irregular dc (rows of 4 and 5): exercises the pad-slot paths
        "gf16_irr": make_peg_code(18, 8, 16, dv=2, seed=5),
        # dv=3 (literature-standard for GF(4)): exercises the dv>2 posterior
        # accumulation paths
        "gf4_dv3": make_peg_code(24, 12, 4, dv=3, seed=5),
        # GF(32): the only odd-p field among the test codes
        "gf32_small": make_peg_code(24, 12, 32, dv=2, seed=5),
    }


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long statistical tests")
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")


def pytest_collection_modifyitems(config, items):
    run_slow = os.environ.get("NBLDPC_SLOW_TESTS") == "1"
    skip_slow = pytest.mark.skip(reason="set NBLDPC_SLOW_TESTS=1 to run")
    for item in items:
        if "slow" in item.keywords and not run_slow:
            item.add_marker(skip_slow)
