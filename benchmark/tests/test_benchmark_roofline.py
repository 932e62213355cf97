"""The bound arithmetic against counts worked out by hand on a one-tile frame."""

from __future__ import annotations

import pytest
import torch

from benchmark import roofline as RF


def one_tile(rows):
    feat = torch.tensor(rows, dtype=torch.float32)
    return feat, torch.tensor([0]), torch.tensor([feat.shape[0]])


def test_power_skips_and_contributions_by_hand():
    # mean at the tile's corner, conic (-1, 0, 0): power = 0.5 dx^2 > 0 off
    # the first pixel column, so those 240 pixels skip on power; the 16 of
    # column 0 (dx = 0, power 0, alpha 0.5) blend.
    feat, ts, te = one_tile([[0.0, 0.0, -1.0, 0.0, 0.0, 0.5, 0.1, 0.2, 0.3]])
    pairs = RF.pair_counts(feat, ts, te, grid_x=1)
    assert pairs == {"visited": 256, "contributing": 16, "power_skipped": 240, "entries_read": 1}
    ops = RF.compositor_ops(RF.composite_ops_per_pair(3), pairs)
    assert ops == 25 * 16 + 11 * 240
    bytes_ = 1 * 9 * 4 + 1 * 2 * 8 + 3 * 4 + 1 * 256 * 4 * 4
    assert RF.composite_fwd_bound_s(pairs, 9, 1, 3) == pytest.approx(
        max(bytes_ / RF.HBM_BYTES_PER_S, ops / RF.FP32_OPS_PER_S))


def test_termination_by_hand():
    # three flat entries of alpha 0.99: the second brings T under 1e-4 (it is
    # visited, not blended: an alpha skip), the third is never visited.
    row = [5.0, 5.0, 0.0, 0.0, 0.0, 0.99, 1.0, 1.0, 1.0]
    feat, ts, te = one_tile([row, row, row])
    pairs = RF.pair_counts(feat, ts, te, grid_x=1)
    assert pairs == {"visited": 512, "contributing": 256, "power_skipped": 0, "entries_read": 2}
    assert RF.compositor_ops(RF.backward_ops_per_pair(3), pairs) == 66 * 256 + 15 * 256
    bwd_bytes = (2 + 3) * 9 * 4 + 2 * 8 + 256 * 6 * 4
    assert RF.composite_bwd_bound_s(pairs, 3, 9, 1, 3) == pytest.approx(
        max(bwd_bytes / RF.HBM_BYTES_PER_S, (66 + 15) * 256 / RF.FP32_OPS_PER_S))


def test_memory_bound_kernels_and_whole_step_counts():
    assert RF.permute_bound_s(1000, 4096) == pytest.approx((1000 * 12 + 4096 * 8) / RF.HBM_BYTES_PER_S)
    assert RF.segment_sum_bound_s(1000, 19, 300) == pytest.approx(
        (1000 * (19 * 4 + 4) + 300 * 19 * 4) / RF.HBM_BYTES_PER_S)
    pairs = {"visited": 10, "contributing": 4, "power_skipped": 3, "entries_read": 2}
    fwd = 4 * (19 + 26) + 3 * 11 + 3 * 15
    bwd = 4 * (54 + 52) + 3 * 11 + 3 * 15
    per_gauss = (RF.PREPROCESS_OPS + RF.SHADE_OPS) * 3 + RF.ADAM_OPS
    assert RF.train_step_ops(pairs, 13, 5, 7) == fwd + bwd + 5 * per_gauss + 7 * 3 * 3 * RF.LOSS_OPS_PER_PIXEL_CHANNEL
    assert RF.frame_ops(pairs, 5, 100) == 200 + 5 * (RF.PREPROCESS_OPS + RF.SHADE_OPS) + (
        4 * 25 + 3 * 11 + 3 * 15)
