import os

# Tests run on the single real CPU device; only the dry-run forces 512
# placeholder devices (and does so in its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402  (JAX_PLATFORMS must be set before importing jax)

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (a CUDA kernel has no CPU mode); skipped "
        "without one")
