"""Test configuration: force CPU with 8 virtual devices so sharding logic is
testable without a GPU (SURVEY.md §4 implication).  The on-device checks
live in chip_smoke.py (`python chip_smoke.py` on one GPU, `--four-cards`
for the distributed modes), not in pytest.

jax.config.update after importing jax pins the CPU even where the
environment names another platform."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags
                               + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
