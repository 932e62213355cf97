"""Per-Gaussian preprocessing: projection, EWA 2D covariance, conic, tile rects.

Port of the JAX package's `ops/preprocess.py` (`PreprocessOut`, `compute_cov2d`,
`sym6_to_mat`, `preprocess`), itself the reference's `preprocessCUDA`. The integer outputs
(radius, tiles_touched, tile rects) must equal the JAX package's exactly, so the
float chains keep its op order: every 3-term projection is written out as
elementwise products summed left to right (no matmul, whose accumulation order
is the library's), and the `floor((m -/+ b) / tile)` rect formulas are kept as
they are.

The opacity-aware rect tightening with `skip_alpha` is kept: at 1/255 it drops
only (Gaussian, tile) pairs that both compositors skip, so the image is
unchanged; larger values are the serving LOD knob. `row_intervals` cuts each
rect further to the ellipse's per-tile-row x-intervals (one CUDA kernel on the
card, `row_intervals_plain` on the CPU); the counts and packed rows equal the
JAX package's bitwise.

The float outputs (mean2d, conic, depth, cov3d) are differentiable with
autograd. The radius and tile-rect chain is derivative-dead (every consumer is
an integer), so it runs without autograd: the opacity that feeds the tightening
gets no gradient from it, as the JAX package's `stop_gradient` says, and no
0 * inf of a dead sqrt or floor can reach the real gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.graphics import covariance_3d, ndc_to_pixel
from .cuda import row_intervals as _row_intervals_kernel


class PreprocessOut(NamedTuple):
    mean2d: torch.Tensor        # [N, 2] pixel-space centers
    conic: torch.Tensor         # [N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor         # [N] view-space z
    radius: torch.Tensor        # [N] int32 screen-space radius, 0 => culled
    tiles_touched: torch.Tensor # [N] int32
    rect_min: torch.Tensor      # [N, 2] int32 (tx, ty) inclusive
    rect_max: torch.Tensor      # [N, 2] int32 (tx, ty) exclusive
    cov3d: torch.Tensor         # [N, 6] world covariance (xx, xy, xz, yy, yz, zz)


def _affine_row(p: torch.Tensor, M: torch.Tensor, i: int) -> torch.Tensor:
    """Row i of M @ [p, 1] for points p [N, 3], summed left to right."""
    return p[:, 0] * M[i, 0] + p[:, 1] * M[i, 1] + p[:, 2] * M[i, 2] + M[i, 3]


def compute_cov2d(p_orig: torch.Tensor, cov3d: torch.Tensor, viewmat: torch.Tensor,
                  focal_x, focal_y, tan_fovx, tan_fovy) -> torch.Tensor:
    """EWA projection of the 3D covariance to screen space.

    Returns [N, 3] 2D covariance (cxx, cxy, cyy) with the +0.3 low-pass applied.
    """
    t0, t1, t2 = (_affine_row(p_orig, viewmat, i) for i in range(3))
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    # Near-culled rows never reach compositing, but must stay finite.
    tz = torch.where(t2 > 0.2, t2, 1.0)
    txtz = t0 / tz
    tytz = t1 / tz
    tx = torch.minimum(torch.maximum(txtz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(tytz, -limy), limy) * tz

    # J = the 2x3 Jacobian of the perspective projection at the clamped point.
    j00 = focal_x / tz
    j02 = -(focal_x * tx) / (tz * tz)
    j11 = focal_y / tz
    j12 = -(focal_y * ty) / (tz * tz)

    W = viewmat[:3, :3]
    m00 = j00 * W[0, 0] + j02 * W[2, 0]
    m01 = j00 * W[0, 1] + j02 * W[2, 1]
    m02 = j00 * W[0, 2] + j02 * W[2, 2]
    m10 = j11 * W[1, 0] + j12 * W[2, 0]
    m11 = j11 * W[1, 1] + j12 * W[2, 1]
    m12 = j11 * W[1, 2] + j12 * W[2, 2]

    a, b, c, d, e, f = (cov3d[:, i] for i in range(6))  # xx xy xz yy yz zz
    v0x = a * m00 + b * m01 + c * m02
    v1x = b * m00 + d * m01 + e * m02
    v2x = c * m00 + e * m01 + f * m02
    v0y = a * m10 + b * m11 + c * m12
    v1y = b * m10 + d * m11 + e * m12
    v2y = c * m10 + e * m11 + f * m12
    cxx = m00 * v0x + m01 * v1x + m02 * v2x + 0.3
    cxy = m10 * v0x + m11 * v1x + m12 * v2x
    cyy = m10 * v0y + m11 * v1y + m12 * v2y + 0.3
    return torch.stack([cxx, cxy, cyy], dim=-1)


def sym6_to_mat(c6: torch.Tensor) -> torch.Tensor:
    """(xx, xy, xz, yy, yz, zz) -> [..., 3, 3] symmetric matrix."""
    xx, xy, xz, yy, yz, zz = (c6[..., i] for i in range(6))
    rows = [torch.stack(r, dim=-1) for r in ((xx, xy, xz), (xy, yy, yz), (xz, yz, zz))]
    return torch.stack(rows, dim=-2)


def _tile_floor(x: torch.Tensor, tile: int, hi: int) -> torch.Tensor:
    return torch.clamp(torch.floor(x / tile), 0, hi).to(torch.int32)


def preprocess(means3d: torch.Tensor, scales: torch.Tensor, quats: torch.Tensor,
               viewmat: torch.Tensor, projmat: torch.Tensor,
               tan_fovx, tan_fovy, width: int, height: int, tile: int,
               scale_modifier: float = 1.0,
               active: torch.Tensor | None = None,
               opacities: torch.Tensor | None = None,
               skip_alpha: float = 1.0 / 255.0,
               cov3d_precomp: torch.Tensor | None = None) -> PreprocessOut:
    """Vectorized equivalent of preprocessCUDA.

    Args:
        means3d: [N, 3] world positions.
        scales: [N, 3] activated (positive) scales.
        quats: [N, 4] normalized quaternions (w, x, y, z).
        viewmat: [4, 4] world->view (math convention).
        projmat: [4, 4] full projection = P @ viewmat.
        tan_fovx, tan_fovy: float32 scalar tensors.
        active: optional [N] bool; rows with False are culled outright.
        opacities: optional [N] or [N, 1] activated opacities; enables the exact
            opacity-aware rect tightening.
        skip_alpha: rect-tightening alpha threshold (1/255 = exact).
        cov3d_precomp: optional [N, 6] world covariance used in place of the
            one built from scales and quats (which may then be None).
    """
    tan_fovx = torch.as_tensor(tan_fovx, dtype=torch.float32, device=means3d.device)
    tan_fovy = torch.as_tensor(tan_fovy, dtype=torch.float32, device=means3d.device)
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile

    p_view_z = _affine_row(means3d, viewmat, 2)
    in_front = p_view_z > 0.2

    p_hom_x = _affine_row(means3d, projmat, 0)
    p_hom_y = _affine_row(means3d, projmat, 1)
    p_w = _affine_row(means3d, projmat, 3)
    inv_w = torch.where(in_front, 1.0 / (p_w + 1e-7), 0.0)
    mean2d = torch.stack(
        [ndc_to_pixel(p_hom_x * inv_w, width), ndc_to_pixel(p_hom_y * inv_w, height)], dim=-1)

    cov3d = (covariance_3d(scales, quats, scale_modifier) if cov3d_precomp is None
             else cov3d_precomp)
    cov = compute_cov2d(means3d, cov3d, viewmat, focal_x, focal_y, tan_fovx, tan_fovy)
    cxx, cxy, cyy = cov[:, 0], cov[:, 1], cov[:, 2]
    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], dim=-1)

    with torch.no_grad():
        return _rects(mean2d, cxx, cxy, cyy, det, det_ok, in_front, conic, p_view_z, cov3d,
                      tile, grid_x, grid_y, active, opacities, skip_alpha)


def _rects(mean2d, cxx, cxy, cyy, det, det_ok, in_front, conic, p_view_z, cov3d,
           tile, grid_x, grid_y, active, opacities, skip_alpha) -> PreprocessOut:
    """Screen radius, visibility and (opacity-tightened) tile rects, in the JAX
    package's op order; run without autograd (module docstring)."""
    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(torch.maximum(lambda1, mid - disc), 0.0)))

    # Reference tile rectangle (exclusive max, clamped to the grid); the
    # visibility filter always uses this square.
    mx, my = mean2d[:, 0], mean2d[:, 1]
    rx_min = _tile_floor(mx - radius_f, tile, grid_x)
    ry_min = _tile_floor(my - radius_f, tile, grid_y)
    rx_max = _tile_floor(mx + radius_f + tile - 1, tile, grid_x)
    ry_max = _tile_floor(my + radius_f + tile - 1, tile, grid_y)
    area = (rx_max - rx_min) * (ry_max - ry_min)

    alive = in_front & det_ok & (area > 0)
    if active is not None:
        alive = alive & active
    radius = torch.where(alive, radius_f, 0.0).to(torch.int32)

    if opacities is not None:
        # Exact opacity-aware tightening (module docstring): pixels with
        # |mx - px| <= bx live in tiles [floor((mx-bx)/tile), floor((mx+bx)/tile)],
        # intersected with the reference square. The 1.0001 factor + 0.5 px absorb
        # float rounding in the compositor's power chain.
        op = opacities[:, 0] if opacities.ndim == 2 else opacities
        # Multiply by the reciprocal: 1/(1/255) rounds to exactly 255.0 in f32.
        tau = torch.sqrt(torch.clamp_min(
            2.0 * torch.log((1.0 / skip_alpha) * torch.clamp_min(op, 1e-12)), 0.0))
        bx = tau * torch.sqrt(torch.clamp_min(cxx, 0.0)) * 1.0001 + 0.5
        by = tau * torch.sqrt(torch.clamp_min(cyy, 0.0)) * 1.0001 + 0.5
        tx0 = _tile_floor(mx - bx, tile, grid_x)
        ty0 = _tile_floor(my - by, tile, grid_y)
        tx1 = torch.clamp(torch.floor((mx + bx) / tile) + 1, 0, grid_x).to(torch.int32)
        ty1 = torch.clamp(torch.floor((my + by) / tile) + 1, 0, grid_y).to(torch.int32)
        rx_min = torch.maximum(rx_min, tx0)
        ry_min = torch.maximum(ry_min, ty0)
        rx_max = torch.minimum(rx_max, tx1)
        ry_max = torch.minimum(ry_max, ty1)
        area_t = torch.clamp_min(rx_max - rx_min, 0) * torch.clamp_min(ry_max - ry_min, 0)
        contributes = alive & (op >= skip_alpha)
        tiles_touched = torch.where(contributes, area_t, 0).to(torch.int32)
        # Keep the rect fields consistent with tiles_touched for the rect walk.
        rx_min = torch.minimum(rx_min, rx_max)
        ry_min = torch.minimum(ry_min, ry_max)
    else:
        tiles_touched = torch.where(alive, area, 0).to(torch.int32)

    return PreprocessOut(
        mean2d=mean2d,
        conic=conic,
        depth=p_view_z,
        radius=radius,
        tiles_touched=tiles_touched,
        rect_min=torch.stack([rx_min, ry_min], dim=-1),
        rect_max=torch.stack([rx_max, ry_max], dim=-1),
        cov3d=cov3d,
    )


H_CAP = 8              # tile rows with exact per-row intervals; deeper rows keep
                       # the full rect width
INTERVAL_MARGIN = 1.0  # px of conservative slack on each interval end
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: saturating, NaN -> 0 (a plain cast is
    undefined out of range)."""
    return torch.nan_to_num(x.double(), nan=0.0).clamp(_I32_MIN, _I32_MAX).to(torch.int32)


def _clip(x, lo, hi):
    """jnp.clip's op order: minimum(maximum(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def row_intervals(pre: PreprocessOut, opacities: torch.Tensor, tile: int = 16,
                  skip_alpha: float = 1.0 / 255.0):
    """The row intervals of `row_intervals_plain` in one pass: the row-interval
    kernel for CUDA tensors (`ops/cuda/row_intervals.py`), the plain version
    for CPU tensors. Both routes return the counts [N] int32 and the packed
    rows [H_CAP, N] as int32 (the plain version's float32 values converted),
    which the binning walks."""
    return _row_intervals_kernel.row_intervals(pre, opacities, tile, skip_alpha)


@torch.no_grad()
def row_intervals_plain(pre: PreprocessOut, opacities: torch.Tensor, tile: int = 16,
                        skip_alpha: float = 1.0 / 255.0):
    """Exact per-tile-row x-intervals of each Gaussian's contributing region.

    Where alpha = op * exp(power) can reach 1/255 is the ellipse
    d^T conic d <= rho^2 with rho^2 = 2 ln(255 op); outside it both compositors
    skip the entry with exactly zero gradients, so dropping those (Gaussian,
    tile) pairs changes neither the image nor a gradient. Cut by a horizontal
    tile-row band the region is one x-interval; for the first H_CAP rows of each
    rect this gives that interval as packed txl_rel + 128 * w_j (both < 128,
    exact in float32), and the resulting entry count. Conservative: continuous
    extent, INTERVAL_MARGIN px of slack each side, clamped to the tightened
    rect; rows past H_CAP keep the full rect width. The chain has no gradient
    (the JAX package's stop_gradients) and keeps the JAX op order bit for bit.

    Returns:
        counts: [N] int32 entries per Gaussian (0 where tiles_touched == 0).
        packed: [H_CAP, N] float32 integers txl_rel + 128 * w_j.
    """
    op = opacities[:, 0] if opacities.ndim == 2 else opacities
    op = op.detach()
    m = pre.mean2d.detach()
    conic = pre.conic.detach()
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    mx, my = m[:, 0], m[:, 1]
    x0, y0 = pre.rect_min[:, 0], pre.rect_min[:, 1]
    x1, y1 = pre.rect_max[:, 0], pre.rect_max[:, 1]
    h = y1 - y0
    w_full = torch.clamp_min(x1 - x0, 0)
    zero_i = torch.zeros_like(w_full)

    rho2 = torch.clamp_min(2.0 * torch.log((1.0 / skip_alpha) * torch.clamp_min(op, 1e-12)), 0.0)
    det_c = torch.clamp_min(a * c - b * b, 1e-30)
    a_s = torch.clamp_min(a, 1e-30)
    dx_max = torch.sqrt(torch.clamp_min(rho2 * c / det_c, 0.0))
    dy_at_xmax = -(b / torch.clamp_min(c, 1e-30)) * dx_max
    dy_max = torch.sqrt(torch.clamp_min(rho2 * a / det_c, 0.0))

    counts = torch.zeros_like(w_full)
    packed_rows = []
    for j in range(H_CAP):
        ty = y0 + j
        live = j < h
        dy0 = ty.to(torch.float32) * tile - my
        dy1 = dy0 + (tile - 1)
        lo = torch.maximum(dy0, -dy_max)
        hi = torch.minimum(dy1, dy_max)
        nonempty = lo <= hi
        # x+ is concave in dy (upper boundary): its band max is at the clamped
        # argmax; x- is convex: its band min at the clamped argmin.
        dyp = _clip(dy_at_xmax, lo, hi)
        sp = torch.clamp_min(a_s * rho2 - det_c * dyp * dyp, 0.0)
        x_hi = mx + (-b * dyp + torch.sqrt(sp)) / a_s + INTERVAL_MARGIN
        dym = _clip(-dy_at_xmax, lo, hi)
        sm = torch.clamp_min(a_s * rho2 - det_c * dym * dym, 0.0)
        x_lo = mx + (-b * dym - torch.sqrt(sm)) / a_s - INTERVAL_MARGIN
        txl = torch.maximum(_f32_to_i32(torch.floor(x_lo / tile)), x0)
        txh = torch.minimum(_f32_to_i32(torch.floor(x_hi / tile)) + 1, x1)
        wj = _clip(txh - txl, zero_i, w_full)
        wj = torch.where(live & nonempty, wj, 0)
        txl_rel = torch.clamp(txl - x0, 0, 127)
        counts = counts + wj
        packed_rows.append(torch.where(wj > 0, txl_rel + 128 * wj, 0).to(torch.float32))
    counts = counts + torch.clamp_min(h - H_CAP, 0) * w_full
    counts = torch.where(pre.tiles_touched > 0, counts, 0).to(torch.int32)
    return counts, torch.stack(packed_rows, dim=0)
