"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
are exercised without a GPU, and the fused kernel runs through the Pallas
interpreter.  Tests of the kernel compiled for the card carry the ``gpu``
marker and skip on the CPU; to run them on a GPU host set
``H2R_TESTS_ON_GPU=1`` (JAX then keeps its default platform):

    H2R_TESTS_ON_GPU=1 python -m pytest -m gpu tests/
"""

import os
import sys

if os.environ.get("H2R_TESTS_ON_GPU") != "1":
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")

# Deep ASTs (e.g. 98-way catch-all alternations nested under +/?) recurse in
# the compiler front-end.
sys.setrecursionlimit(100_000)
