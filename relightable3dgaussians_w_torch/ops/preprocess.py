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

`preprocess` is one differentiable operation (`_Preprocess`): on the card its
forward is kernel R and its backward kernel R' (`csrc/preprocess.cu`,
`ops/cuda/preprocess.py`), R bitwise equal to the plain chain; on the CPU its
forward is `preprocess_plain`, the unchanged chain, and its backward
`preprocess_backward_plain`, the analytic gradient written from the same
derivation as R', step for step, so that the CPU tests against autograd and
the JAX package hold the derivation the kernel runs. Neither direction saves
anything but the inputs, and nothing when no input needs a gradient.
Gradients flow from mean2d, conic, depth and cov3d to the positions, scales
and rotations (or a precomputed covariance). The radius and tile-rect chain
is derivative-dead (every consumer is an integer): the opacity that feeds the
tightening gets no gradient from it, as the JAX package's `stop_gradient`
says, and the camera is a constant of the operation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.graphics import _rotmat_entries, covariance_3d, ndc_to_pixel
from .cuda import preprocess as _preprocess_kernel
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


def preprocess_plain(means3d: torch.Tensor, scales: torch.Tensor, quats: torch.Tensor,
                     viewmat: torch.Tensor, projmat: torch.Tensor,
                     tan_fovx, tan_fovy, width: int, height: int, tile: int,
                     scale_modifier: float = 1.0,
                     active: torch.Tensor | None = None,
                     opacities: torch.Tensor | None = None,
                     skip_alpha: float = 1.0 / 255.0,
                     cov3d_precomp: torch.Tensor | None = None) -> PreprocessOut:
    """Vectorized equivalent of preprocessCUDA, in plain PyTorch: the chain
    kernel R is held to bit for bit. Its float outputs are differentiable with
    autograd; the rect chain runs without it (`_rects`).

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
    package's op order; run without autograd, so no 0 * inf of a dead sqrt or
    floor can reach the real gradients."""
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


# ------------------------------------------------------------------ backward


def _dmax(a, b):
    """d maximum(a, b) / d a as autograd takes it: half at a tie."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def _dmin(a, b):
    """d minimum(a, b) / d a as autograd takes it: half at a tie."""
    return torch.where(a < b, 1.0, torch.where(a == b, 0.5, 0.0))


def preprocess_backward_plain(means3d, scales, quats, viewmat, projmat, tan_fovx, tan_fovy,
                              width: int, height: int, scale_modifier: float = 1.0,
                              cov3d_precomp=None, g_mean2d=None, g_conic=None, g_depth=None,
                              g_cov3d=None):
    """The gradient of `preprocess_plain`'s float outputs, analytic, written
    step for step as kernel R' (csrc/preprocess.cu) computes it: the forward
    recomputed from the inputs, then the center, the conic, the screen
    covariance, the Jacobian, the frustum clamp, the view rows and the world
    covariance in turn. Cotangents: g_mean2d [N, 2], g_conic [N, 3] (None:
    zeros), g_depth [N] and g_cov3d [N, 6] or None.

    Returns:
        (d_means3d [N, 3], d_scales [N, 3], d_quats [N, 4], d_cov3d_precomp
        [N, 6]): d_scales and d_quats None with cov3d_precomp, d_cov3d_precomp
        None without.
    """
    p = means3d
    zeros = lambda k: torch.zeros((p.shape[0], k), dtype=p.dtype, device=p.device)
    gm = zeros(2) if g_mean2d is None else g_mean2d
    gc = zeros(3) if g_conic is None else g_conic
    tan_fovx = torch.as_tensor(tan_fovx, dtype=torch.float32, device=p.device)
    tan_fovy = torch.as_tensor(tan_fovy, dtype=torch.float32, device=p.device)
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    if cov3d_precomp is None:
        R = _rotmat_entries(quats)
        s = [scale_modifier * scales[:, k] for k in range(3)]
        s2 = [sk * sk for sk in s]
        cov3d = covariance_3d(scales, quats, scale_modifier)
    else:
        cov3d = cov3d_precomp
    V, P = viewmat, projmat

    # The forward's intermediates (compute_cov2d, the conic).
    t0, t1, t2 = (_affine_row(p, V, i) for i in range(3))
    in_front = t2 > 0.2
    tz = torch.where(in_front, t2, 1.0)
    txtz, tytz = t0 / tz, t1 / tz
    mx_x = torch.maximum(txtz, -limx)
    clx = torch.minimum(mx_x, limx)
    mx_y = torch.maximum(tytz, -limy)
    cly = torch.minimum(mx_y, limy)
    tx, ty = clx * tz, cly * tz
    tz2 = tz * tz
    j00, j02 = focal_x / tz, -(focal_x * tx) / tz2
    j11, j12 = focal_y / tz, -(focal_y * ty) / tz2
    m0 = [j00 * V[0, k] + j02 * V[2, k] for k in range(3)]
    m1 = [j11 * V[1, k] + j12 * V[2, k] for k in range(3)]
    a, b, c, d, e, f = (cov3d[:, i] for i in range(6))
    S = ((a, b, c), (b, d, e), (c, e, f))
    vx = [S[r][0] * m0[0] + S[r][1] * m0[1] + S[r][2] * m0[2] for r in range(3)]
    vy = [S[r][0] * m1[0] + S[r][1] * m1[1] + S[r][2] * m1[2] for r in range(3)]
    cxx = m0[0] * vx[0] + m0[1] * vx[1] + m0[2] * vx[2] + 0.3
    cxy = m1[0] * vx[0] + m1[1] * vx[1] + m1[2] * vx[2]
    cyy = m1[0] * vy[0] + m1[1] * vy[1] + m1[2] * vy[2] + 0.3
    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    di = 1.0 / torch.where(det_ok, det, 1.0)

    # The center: mean2d = ((u + 1) W - 1) / 2, u = ph * inv_w.
    ph_x, ph_y, pw = (_affine_row(p, P, i) for i in (0, 1, 3))
    inv_w = torch.where(in_front, 1.0 / (pw + 1e-7), 0.0)
    gu = gm[:, 0] * 0.5 * width
    gv = gm[:, 1] * 0.5 * height
    g_phx, g_phy = gu * inv_w, gv * inv_w
    g_invw = gu * ph_x + gv * ph_y
    g_pw = torch.where(in_front, -g_invw * inv_w * inv_w, 0.0)

    # The conic (cyy, -cxy, cxx) / det, det = cxx cyy - cxy^2.
    g_cxx, g_cxy, g_cyy = gc[:, 2] * di, -gc[:, 1] * di, gc[:, 0] * di
    g_di = gc[:, 0] * cyy - gc[:, 1] * cxy + gc[:, 2] * cxx
    g_det = torch.where(det_ok, -g_di * di * di, 0.0)
    g_cxx = g_cxx + g_det * cyy
    g_cyy = g_cyy + g_det * cxx
    g_cxy = g_cxy - 2.0 * cxy * g_det

    # The screen covariance: cxx = m0' S m0, cxy = m1' S m0, cyy = m1' S m1;
    # gS[(j, k)] sums the full matrix's (j, k) and (k, j) entries.
    gS = []
    for u, (j, k) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
        if j == k:
            g = g_cxx * m0[j] * m0[j] + g_cxy * m1[j] * m0[j] + g_cyy * m1[j] * m1[j]
        else:
            g = (2.0 * g_cxx * m0[j] * m0[k] + g_cxy * (m1[j] * m0[k] + m1[k] * m0[j])
                 + 2.0 * g_cyy * m1[j] * m1[k])
        gS.append(g if g_cov3d is None else g + g_cov3d[:, u])
    g_m0 = [2.0 * g_cxx * vx[k] + g_cxy * vy[k] for k in range(3)]
    g_m1 = [g_cxy * vx[k] + 2.0 * g_cyy * vy[k] for k in range(3)]

    # J: m0 = j00 W0 + j02 W2, m1 = j11 W1 + j12 W2; j00 = fx / tz,
    # j02 = -fx tx / tz^2, j11 = fy / tz, j12 = -fy ty / tz^2.
    g_j00 = g_m0[0] * V[0, 0] + g_m0[1] * V[0, 1] + g_m0[2] * V[0, 2]
    g_j02 = g_m0[0] * V[2, 0] + g_m0[1] * V[2, 1] + g_m0[2] * V[2, 2]
    g_j11 = g_m1[0] * V[1, 0] + g_m1[1] * V[1, 1] + g_m1[2] * V[1, 2]
    g_j12 = g_m1[0] * V[2, 0] + g_m1[1] * V[2, 1] + g_m1[2] * V[2, 2]
    g_tz = -(g_j00 * j00 + g_j11 * j11 + 2.0 * (g_j02 * j02 + g_j12 * j12)) / tz
    g_tx = -(g_j02 * focal_x) / tz2
    g_ty = -(g_j12 * focal_y) / tz2
    # tx = min(max(t0 / tz, -limx), limx) tz.
    g_tz = g_tz + g_tx * clx + g_ty * cly
    g_txtz = g_tx * tz * _dmin(mx_x, limx) * _dmax(txtz, -limx)
    g_tytz = g_ty * tz * _dmin(mx_y, limy) * _dmax(tytz, -limy)
    g_tz = g_tz - (g_txtz * txtz + g_tytz * tytz) / tz
    g_t0, g_t1 = g_txtz / tz, g_tytz / tz
    g_t2 = torch.where(in_front, g_tz, 0.0)
    if g_depth is not None:
        g_t2 = g_t2 + g_depth
    d_means = torch.stack([g_t0 * V[0, k] + g_t1 * V[1, k] + g_t2 * V[2, k] + g_phx * P[0, k]
                           + g_phy * P[1, k] + g_pw * P[3, k] for k in range(3)], dim=-1)
    if cov3d_precomp is not None:
        return d_means, None, None, torch.stack(gS, dim=-1)

    # S = R diag(s^2) R', s = scale_modifier * scales.
    gxx, gxy, gxz, gyy, gyz, gzz = gS
    d_scales, gR = [], [None] * 9
    for k in range(3):
        r0, r1, r2 = R[k], R[3 + k], R[6 + k]
        g_s2 = (gxx * r0 * r0 + gxy * r0 * r1 + gxz * r0 * r2 + gyy * r1 * r1
                + gyz * r1 * r2 + gzz * r2 * r2)
        d_scales.append(g_s2 * 2.0 * s[k] * scale_modifier)
        gR[k] = s2[k] * (2.0 * gxx * r0 + gxy * r1 + gxz * r2)
        gR[3 + k] = s2[k] * (gxy * r0 + 2.0 * gyy * r1 + gyz * r2)
        gR[6 + k] = s2[k] * (gxz * r0 + gyz * r1 + 2.0 * gzz * r2)
    # The rotation's entries in the quaternion (w, x, y, z).
    w, x, y, z = (quats[:, k] for k in range(4))
    gw = 2.0 * (-z * gR[1] + y * gR[2] + z * gR[3] - x * gR[5] - y * gR[6] + x * gR[7])
    gx = 2.0 * (y * gR[1] + z * gR[2] + y * gR[3] - 2.0 * x * gR[4] - w * gR[5] + z * gR[6]
                + w * gR[7] - 2.0 * x * gR[8])
    gy = 2.0 * (-2.0 * y * gR[0] + x * gR[1] + w * gR[2] + x * gR[3] + z * gR[5] - w * gR[6]
                + z * gR[7] - 2.0 * y * gR[8])
    gz = 2.0 * (-2.0 * z * gR[0] - w * gR[1] + x * gR[2] + w * gR[3] - 2.0 * z * gR[4]
                + y * gR[5] + x * gR[6] + y * gR[7])
    return (d_means, torch.stack(d_scales, dim=-1), torch.stack([gw, gx, gy, gz], dim=-1),
            None)


# ------------------------------------------------------------------ the operation


class _Options(NamedTuple):
    width: int
    height: int
    tile: int
    scale_modifier: float
    skip_alpha: float


def _camera_on(dev, viewmat, projmat, tan_fovx, tan_fovy):
    """The kernels' camera tensors: float32, contiguous, on `dev`."""
    return tuple(t.to(dev, torch.float32).contiguous()
                 for t in (viewmat, projmat, tan_fovx, tan_fovy))


def _rows(t):
    return None if t is None else t.contiguous()


class _Preprocess(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means3d, scales, quats, cov3d_precomp, opacities, active, viewmat,
                projmat, tan_fovx, tan_fovy, opts: _Options):
        ctx.set_materialize_grads(False)
        ctx.opts = opts
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(means3d, scales, quats, cov3d_precomp, viewmat, projmat,
                                  tan_fovx, tan_fovy)
        if means3d.is_cuda:
            out = _preprocess_kernel.preprocess_forward(
                means3d.contiguous(), _rows(scales), _rows(quats), _rows(cov3d_precomp),
                _rows(opacities), _rows(active),
                _camera_on(means3d.device, viewmat, projmat, tan_fovx, tan_fovy),
                opts.width, opts.height, opts.tile, opts.scale_modifier, opts.skip_alpha)
        else:
            out = preprocess_plain(means3d, scales, quats, viewmat, projmat, tan_fovx,
                                   tan_fovy, opts.width, opts.height, opts.tile,
                                   opts.scale_modifier, active, opacities, opts.skip_alpha,
                                   cov3d_precomp)
        ctx.mark_non_differentiable(*out[3:7])
        return tuple(out)

    @staticmethod
    def backward(ctx, g_mean2d, g_conic, g_depth, _radius, _tiles, _rmin, _rmax, g_cov3d):
        nothing = (None,) * 11
        if g_mean2d is None and g_conic is None and g_depth is None and g_cov3d is None:
            return nothing
        means3d, scales, quats, cov3d_precomp, viewmat, projmat, tanx, tany = ctx.saved_tensors
        o = ctx.opts
        with torch.profiler.record_function("rasterize.preprocess_backward"):
            if means3d.is_cuda:
                n, dev = means3d.shape[0], means3d.device
                zeros = lambda k: torch.zeros((n, k), dtype=torch.float32, device=dev)
                grads = _preprocess_kernel.preprocess_backward(
                    means3d.contiguous(), _rows(scales), _rows(quats), _rows(cov3d_precomp),
                    _camera_on(dev, viewmat, projmat, tanx, tany), o.width, o.height,
                    o.scale_modifier, zeros(2) if g_mean2d is None else g_mean2d,
                    zeros(3) if g_conic is None else g_conic, g_depth, g_cov3d)
            else:
                grads = preprocess_backward_plain(
                    means3d, scales, quats, viewmat, projmat, tanx, tany, o.width, o.height,
                    o.scale_modifier, cov3d_precomp, g_mean2d, g_conic, g_depth, g_cov3d)
        grads = tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))
        return grads + nothing[4:]


def preprocess(means3d: torch.Tensor, scales: torch.Tensor, quats: torch.Tensor,
               viewmat: torch.Tensor, projmat: torch.Tensor,
               tan_fovx, tan_fovy, width: int, height: int, tile: int,
               scale_modifier: float = 1.0,
               active: torch.Tensor | None = None,
               opacities: torch.Tensor | None = None,
               skip_alpha: float = 1.0 / 255.0,
               cov3d_precomp: torch.Tensor | None = None) -> PreprocessOut:
    """Vectorized equivalent of preprocessCUDA: kernels R and R' on the card,
    the plain chain and its analytic gradient on the CPU (module docstring).

    Args:
        means3d: [N, 3] world positions.
        scales: [N, 3] activated (positive) scales.
        quats: [N, 4] normalized quaternions (w, x, y, z).
        viewmat: [4, 4] world->view (math convention).
        projmat: [4, 4] full projection = P @ viewmat.
        tan_fovx, tan_fovy: float32 scalar tensors.
        active: optional [N] bool; rows with False are culled outright.
        opacities: optional [N] or [N, 1] activated opacities; enables the exact
            opacity-aware rect tightening (no gradient flows to them).
        skip_alpha: rect-tightening alpha threshold (1/255 = exact).
        cov3d_precomp: optional [N, 6] world covariance used in place of the
            one built from scales and quats (which may then be None).
    """
    dev = means3d.device
    tan_fovx = torch.as_tensor(tan_fovx, dtype=torch.float32, device=dev)
    tan_fovy = torch.as_tensor(tan_fovy, dtype=torch.float32, device=dev)
    if any(t.requires_grad for t in (viewmat, projmat, tan_fovx, tan_fovy)):
        raise ValueError("preprocess: the camera is a constant of the operation (no gradient "
                         "flows to it)")
    if opacities is not None:
        opacities = (opacities[:, 0] if opacities.ndim == 2 else opacities).detach()
    if cov3d_precomp is not None:
        scales = quats = None
    out = _Preprocess.apply(means3d, scales, quats, cov3d_precomp, opacities, active, viewmat,
                            projmat, tan_fovx, tan_fovy,
                            _Options(int(width), int(height), int(tile), float(scale_modifier),
                                     float(skip_alpha)))
    return PreprocessOut(*out)


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
