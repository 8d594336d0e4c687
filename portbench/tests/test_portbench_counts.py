"""The yardstick's counts at the published shapes (B = 20,000 frames of 10
atoms, heads [30, 20, 20, 20, 1], k = 2)."""

import pytest

from portbench import counts

DIMS, K, B, N = [30, 20, 20, 20, 1], 2, 20_000, 10


def test_kernel_bytes_and_flops():
    assert counts.k1_bytes(B) == pytest.approx(1.44e6)
    assert counts.k2_bytes(B, N) == pytest.approx(4.80e6)
    assert counts.k3_flops(B, K, DIMS) == pytest.approx(227.2e6)
    assert counts.k4_flops(B, K, DIMS) == pytest.approx(585.6e6)


def test_bounds():
    assert counts.bound_seconds(nbytes=4.80e6) == pytest.approx(1.4328e-6,
                                                               rel=1e-4)
    assert counts.bound_seconds(flops=227.2e6) == pytest.approx(3.391e-6,
                                                               rel=1e-3)
    assert counts.bound_seconds(flops=585.6e6) == pytest.approx(8.740e-6,
                                                               rel=1e-3)


def test_model_flops_per_sample():
    macs = 30 * 20 + 20 * 20 + 20 * 20 + 20 * 1
    inner = macs - 30 * 20
    transfer = dict(loss="transfer", layer_dims=DIMS, k=K)
    # forward, weight gradients and the inner input gradients, X and X_l
    assert counts.model_flops_per_sample(transfer) == \
        2 * K * (2 * macs + 2 * macs + 2 * inner)
    generator = dict(loss="generator", layer_dims=DIMS, k=K)
    quad = 2 * 30 * 30 + 2 * 30
    assert counts.model_flops_per_sample(generator) == \
        K * (3 * (4 * macs) + 2 * quad)
    with pytest.raises(ValueError):
        counts.model_flops_per_sample(dict(loss="none", layer_dims=DIMS, k=K))
