"""On-card parity of the hot path (phase 1 of chip_smoke.py at N=1e4).

Marked ``gpu``: it skips unless JAX's first device is a CUDA GPU.  Run it
on the card with the command named in README.md.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a CUDA GPU; JAX platform is {platform!r}")


def test_hot_path_parity_on_gpu(gpu):
    record = chip_smoke.phase_hot_f32(n=10_000, chain_len=10)
    assert record["auto_tier"] == "assoc"
