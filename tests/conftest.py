"""Tests run hermetically on CPU with a virtual 8-device mesh available.

The platform is pinned with ``jax.config.update`` before any test module
triggers device use; the GPU kernel runs in Pallas interpret mode there.
Tests that only a GPU can run carry the ``gpu`` marker and skip inside
the test elsewhere; on a GPU host run them with
``SIFT4G_TEST_GPU=1 python -m pytest tests/ -m gpu``, which leaves JAX
on its default (GPU) platform.
"""

import os

ON_GPU = os.environ.get("SIFT4G_TEST_GPU") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not ON_GPU and "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# never drop .s4gc parse caches next to inputs during tests (the e2e
# goldens read from the read-only reference tree); individual tests of the
# DEFAULT next-to-input layout delete this var via monkeypatch
if "SIFT4G_TPU_CACHE_DIR" not in os.environ:
    import tempfile

    os.environ["SIFT4G_TPU_CACHE_DIR"] = tempfile.mkdtemp(
        prefix="sift4g-tpu-test-cache-"
    )

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

REFERENCE_TEST_FILES = "/root/reference/test_files"
