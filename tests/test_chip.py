"""Checks of what the GPU itself computes (marker ``chip``).

They skip without a GPU.  On the card:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_chip.py -m chip -p no:cacheprovider

Each runs one of chip_smoke.py's checks at a smaller batch: the k-means
kernel against the plain estimator, the demapper against the float64
oracle, and one flagship chunk from the same key on the CPU and the GPU.
"""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.chip


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's first device is {dev.platform}); "
                    "run on the card with JAX_PLATFORMS=cuda,cpu")
    return dev


@pytest.mark.parametrize("label,fname,nsym", chip_smoke.KMEANS_SHAPES)
def test_kmeans_kernel_matches_plain(gpu, label, fname, nsym):
    chip_smoke.kmeans_agreement(label, fname, nsym, b=256, seed=11)


def test_demap_matches_float64_oracle(gpu):
    chip_smoke.phase_demap(b=256)


def test_same_seed_cpu_and_gpu(gpu):
    chip_smoke.phase_same_seed(b=256)
