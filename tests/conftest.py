"""Test configuration: run everything on a virtual 8-device CPU mesh so
multi-chip sharding paths are exercised without TPU hardware.

Note: this environment's jax build force-prepends its TPU platform to
JAX_PLATFORMS, so the env var alone is not enough — we must also override
the config after import (and XLA_FLAGS must be set before jax loads)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu"

# persistent compilation cache: model-build/jit-heavy tests compile once
# per machine instead of once per pytest run
jax.config.update("jax_compilation_cache_dir", "/tmp/dmcf_jax_test_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's hand-written "
        "kernels); skipped where torch.cuda.is_available() is false")
