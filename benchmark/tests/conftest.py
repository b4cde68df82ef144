"""CPU tests of the benchmark (``python -m pytest benchmark/tests``).

Tests that need a CUDA card carry the ``card`` marker and decide inside
the test whether one is there."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny shapes of each cell, for the CPU
TINY = {
    "train_unet32_auto": {
        "config": {"model": {"init_features": 4}, "patch_size": 32, "static_num_patches": 128,
                   "batch_size": 32},
        "traffic": {"pool": 2, "waterfalls": {"count": 2, "channels": 128, "times": 128}}},
    "flag_unet16_model_8x1024": {
        "config": {"predictor_batch": 4},
        "traffic": {"pool": 2, "waterfalls": {"count": 2, "channels": 256, "times": 256}}},
    "flag_mad_vla_block": {
        "traffic": {"pool": 2, "waterfalls": {"count": 6, "channels": 256, "times": 128}}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def tiny():
    return TINY
