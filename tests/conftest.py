"""Test configuration.

* By default the suite runs on an 8-device virtual CPU mesh, so sharding
  paths are exercised without GPUs (SURVEY.md §4: multi-host tests on CPU
  sim).  ``KMERS_TEST_DEVICE=gpu`` leaves JAX's own platform choice alone,
  for the ``gpu``-marked lane on a machine with a card:
  ``KMERS_TEST_DEVICE=gpu python -m pytest tests/ -m gpu``.
* The persistent compilation cache is shared with every other entry point
  (kmers_tpu.compile_cache): per-shape XLA compiles cost ~1s on the CPU,
  so tests keep array shapes canonical and reuse compiled executables
  across runs.
"""

import os

import pytest

_ON_GPU = os.environ.get("KMERS_TEST_DEVICE") == "gpu"

if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

from kmers_tpu import compile_cache  # noqa: E402

compile_cache.configure()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: tests marked ``gpu`` compile for the card
    and have no CPU form.  Decided here, at run time, never at import."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (KMERS_TEST_DEVICE=gpu on a machine with "
                    "a card)")
    return devices[0]
