"""The frozen counts reproduce chip_smoke.py's bounds and train/flops.py."""

import pytest

from benchmark import counts

PX = 128 * 128


@pytest.mark.parametrize("n_bytes, ms", [
    (counts.k1_bytes(512, 1920, PX), 0.1327),
    (counts.k3_identity_bytes(1920, PX), 0.2254),
    (counts.k4_bytes(512, PX), 0.0501),
    (counts.k5_bytes(512, PX), 0.0225),
])
def test_kernel_bounds(n_bytes, ms):
    assert round(counts.bound_ms(n_bytes), 4) == ms


def test_unet_operations():
    assert round(counts.unet_train_flops(128) / 1e12, 3) == 2.318
    assert round(counts.unet_forward_flops(1, f=16) / 1e9, 3) == 1.516
    assert round(counts.unet_forward_flops(512, f=16) / 1e12, 3) == 0.776


def test_kernel_classes():
    assert counts.port_kernel("void (anonymous namespace)::mad_flags_kernel<true, true>()",
                              "mad_flag")
    assert counts.port_kernel("void cluster_extract_kernel<2, true>(...)", "cluster_extract")
    assert counts.classify("sm90_xmma_fprop_implicit_gemm_bf16") == "convolutions (cuDNN)"
    assert counts.classify("Memcpy DtoD (Device -> Device)") == "copies"
