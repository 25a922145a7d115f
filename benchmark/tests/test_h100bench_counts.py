"""The FLOP and byte counts of the mfu metrics and the rooflines against
hand counts at the cells' shapes."""

import pytest

from benchmark.reference import flops


def test_expert_step_at_switch8_dispatch():
    # forward x w1, h w2: 2 * 2 * N * D * F; backward h^T dy, dy w2^T,
    # x^T dh: 3 * 2 * N * D * F
    n, d, f = 32768, 768, 3072
    assert flops.expert_step(n, d, f) == 4 * n * d * f + 6 * n * d * f
    assert flops.expert_step(n, d, f) == 773_094_113_280


def test_flash_forward_at_mpt7b_ulysses():
    h, t, d = 32, 65536, 128
    live = t * (t + 1) // 2                        # causal pairs a head
    got = flops.flash_fwd(h, t, d, causal=True)
    assert got["flops"] == 2 * 2 * d * live * h    # QK^T and PV
    assert got["flops"] == 35_184_908_959_744
    # q, k, v read, o written: 4 * [H, T, D] float32, lse [H, T]
    assert got["bytes"] == 4 * (4 * h * t * d + h * t)


def test_flash_kernels_at_switch8_train():
    bh, t, d = 64 // 2 * 12, 512, 64               # [384, 512, 64]
    live = bh * t * (t + 1) // 2
    fwd = flops.flash_fwd(bh, t, d, True)
    bwd = flops.flash_bwd(bh, t, d, True)
    assert fwd["flops"] == 4 * d * live
    assert bwd["flops"] == 10 * d * live           # S, dP, dV, dQ, dK
    # q, k, v, dO read and dq, dk, dv written; lse and delta read
    assert bwd["bytes"] == 4 * (7 * bh * t * d + 2 * bh * t)
    assert flops.flash_fwd(bh, t, d, False)["flops"] == 4 * d * bh * t * t


def test_transformer_step_at_switch8_train():
    V, D, H, Dh, F, L, E, T, B = 32128, 768, 12, 64, 3072, 12, 8, 512, 64
    per_token_layer = (2 * D * 3 * H * Dh      # q, k, v
                       + 2 * H * Dh * D        # output projection
                       + 2 * D * E             # router
                       + 2 * 2 * D * F)        # one expert's two products
    attention = L * B * H * 4 * Dh * (T * (T + 1) // 2)
    forward = B * T * (L * per_token_layer + 2 * D * V) + attention
    assert flops.transformer_step(V, D, H, Dh, F, L, E, T, B) == 3 * forward
    assert flops.transformer_step(V, D, H, Dh, F, L, E, T, B) \
        == pytest.approx(2.2494e13, rel=1e-4)


def test_segment_move_counts_each_byte_twice():
    payload = 32768 * 770 * 4
    assert flops.segment_move(payload) == {"flops": 0.0,
                                           "bytes": 2.0 * payload}
