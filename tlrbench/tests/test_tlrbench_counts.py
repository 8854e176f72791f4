"""The frozen operation and byte counts against hand-counted tiny cases."""

from __future__ import annotations

import numpy as np
import pytest

from tlrbench.frozen import counts


def test_tile_chain_counts_each_word_once():
    # T=2 tiles, b=4, width 3, s=2, live ranks 3 and 1
    words, flops = counts.sampling_call("tile_chain", (2, 4, 3, 2), [3, 1])
    # U and V: 2 * b * (3 + 1); X read and out written: 2 * T * b * s
    assert words == 2 * 4 * 4 + 2 * 2 * 4 * 2
    assert flops == 4 * 4 * 2 * 4


def test_lr_sample_counts_each_word_once():
    # T=2, J=3, b=4, width 5, s=2
    live = np.array([[5, 0, 2], [1, 1, 1]])
    words, flops = counts.sampling_call("lr_sample", (2, 3, 4, 5, 2), live)
    R = 5 + 0 + 2 + 1 + 1 + 1
    assert words == 2 * 4 * R + 3 * 4 * 2 + 2 * 4 * 2
    assert flops == 4 * 4 * 2 * R


def test_batched_gemm_counts_live_rows_and_clamps():
    # T=3, m=4, k=6, n=2, ranks past k and below 0 clamp
    words, flops = counts.sampling_call("batched_gemm", (3, 4, 6, 2),
                                        [2, 9, -1])
    R = 2 + 6 + 0
    assert words == 4 * R + 2 * R + 3 * 4 * 2
    assert flops == 2 * 4 * 2 * R


@pytest.mark.parametrize("kind, shape, padded, live", [
    ("tile_chain", (2, 512, 128, 16), [128, 128], [20, 7]),
    ("lr_sample", (2, 3, 512, 128, 16), np.full((2, 3), 128),
     np.array([[20, 0, 5], [1, 2, 3]])),
    ("batched_gemm", (2, 512, 128, 16), [128, 128], [20, 7]),
])
def test_padded_width_is_not_counted(kind, shape, padded, live):
    w_pad, f_pad = counts.sampling_call(kind, shape, padded)
    w_live, f_live = counts.sampling_call(kind, shape, live)
    assert w_live < w_pad and f_live < f_pad
    # the difference is exactly the dead columns' words and products
    dead = float(np.sum(padded) - np.sum(live))
    b = shape[-3] if kind != "batched_gemm" else shape[1]
    s = shape[-1]
    if kind == "batched_gemm":
        assert w_pad - w_live == (shape[1] + s) * dead
        assert f_pad - f_live == 2 * shape[1] * s * dead
    else:
        assert w_pad - w_live == 2 * b * dead
        assert f_pad - f_live == 4 * b * s * dead


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert counts.bound_seconds(1e9, 1.0, 8, 1e12, 1e12) == 8e-3
    assert counts.bound_seconds(1.0, 1e12, 8, 1e12, 1e12) == 1.0


def test_cholesky_flops_two_tiles_by_hand():
    # nb=2, b=4, bs=2: one lower tile (1, 0), A rank 3, L rank 3
    b, bs = 4, 2
    total = counts.cholesky_flops(np.array([3]), np.array([3]), 2, b, bs)
    s = bs * (np.ceil(3 / bs) + 1)          # 6 samples, 3 blocks
    blocks = s / bs
    want = 2 * b**3 / 3                     # two diagonal Cholesky
    want += 4 * b * 3**2 + 2 * b * b * 3    # column 1's diagonal update
    want += 4 * b * s * 3                   # samples of A(1, 0)
    want += 8 * b * bs * bs * blocks * (blocks - 1) / 2 \
        + 2 * b * bs * bs * blocks          # Gram-Schmidt and QR
    want += 4 * b * 3 * 3                   # projection A(1, 0)^T Q
    want += b * b * 3                       # triangular solve with L_00
    assert total == pytest.approx(want, rel=1e-15)


def test_cholesky_flops_three_tiles_counts_prior_columns():
    # nb=3: tile (2, 1) sees L(2, 0) and L(1, 0) of column 0
    b, bs = 4, 2
    a = np.array([1, 1, 1])        # (1,0), (2,0), (2,1)
    l0 = np.array([2, 2, 2])
    l1 = np.array([2, 4, 2])       # L(2,0) wider
    assert counts.cholesky_flops(a, l1, 3, b, bs) > \
        counts.cholesky_flops(a, l0, 3, b, bs)


def test_pcg_flops_by_hand():
    nb, b = 2, 4
    a, lr = np.array([3]), np.array([2])
    per = (2 * nb * b * b + 8 * b * 3) + 2 * (nb * b * b + 4 * b * 2) \
        + 12 * nb * b
    assert counts.pcg_flops(a, lr, nb, b, 5) == 6 * per
