"""The reference render: illumination MLP -> per-Gaussian Cook-Torrance SH
shading -> projection -> (tile, depth) binning -> gather -> front-to-back
alpha compositing over 16 x 16 tiles.

Plain float32 PyTorch with no kernel and no entry budget: every (Gaussian,
tile) entry is kept. It follows the published method (the reference
repository's `gaussian_renderer` and `scene/NVDIFFREC/light.py`, as the port's
plain versions write it out: the same op order for every predicate that
decides a skip or the end of a pixel, so a correct program agrees to
rounding). The compositor's backward is the closed form of the port's plain
version, an autograd Function here; everything else differentiates with
autograd.

Scenes come in as a `Splats` of raw (pre-activation) leaves; the MLP as a
dict of the six layers' weights and biases ("dense.{i}.weight" / ".bias").
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lut as LUT
from . import mathops as M

ALPHA_MIN = 1.0 / 255.0
ALPHA_SAT = 0.99
T_EPS = 1e-4
KEEP_PROB = 0.8
C1, C2, C3, C4, C5 = 0.429043, 0.511664, 0.743125, 0.886227, 0.247708


class Splats(NamedTuple):
    """Raw leaves of a Gaussian pool (rows beyond `alive` are inert)."""
    xyz: torch.Tensor         # [N, 3]
    albedo: torch.Tensor      # [N, 3] pre-sigmoid
    opacity: torch.Tensor     # [N, 1] pre-sigmoid
    scaling: torch.Tensor     # [N, 3] log
    rotation: torch.Tensor    # [N, 4] unnormalized (w, x, y, z)
    roughness: torch.Tensor   # [N, 1] pre-sigmoid
    metalness: torch.Tensor   # [N, 1] pre-sigmoid
    sky_angles: torch.Tensor  # [N, 2]
    sky_radius: torch.Tensor  # []
    alive: torch.Tensor       # [N] bool
    is_sky: torch.Tensor      # [N] bool
    sky_center: torch.Tensor  # [3]


class Camera(NamedTuple):
    viewmat: torch.Tensor     # [4, 4] world -> view
    projmat: torch.Tensor     # [4, 4] projection @ viewmat
    campos: torch.Tensor      # [3]
    tan_fovx: torch.Tensor    # []
    tan_fovy: torch.Tensor    # []
    width: int
    height: int


def camera(viewmat: np.ndarray, fovx: float, fovy: float, width: int, height: int,
           device) -> Camera:
    """The camera of a world -> view matrix and fields of view (znear 0.01,
    zfar 100, as the reference's `getProjectionMatrix`)."""
    viewmat = np.asarray(viewmat, np.float32)
    proj = M.projection_matrix(0.01, 100.0, fovx, fovy) @ viewmat
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Camera(f32(viewmat), f32(proj), f32(np.linalg.inv(viewmat)[:3, 3]),
                  f32(np.tan(fovx / 2)), f32(np.tan(fovy / 2)), width, height)


# ------------------------------------------------------------------ scene


def xyz_of(s: Splats) -> torch.Tensor:
    theta = torch.clamp(s.sky_angles[:, 0], 0.0, np.pi / 2)
    phi = torch.clamp(s.sky_angles[:, 1], -np.pi / 2, np.pi / 2)
    sky = M.polar_to_cartesian(torch.stack([theta, phi], -1), s.sky_center, s.sky_radius)
    return torch.where(s.is_sky[:, None], sky, s.xyz)


def opacity_of(s: Splats) -> torch.Tensor:
    return torch.sigmoid(s.opacity) * s.alive[:, None]


def mlp(weights: dict, e: torch.Tensor, keep: torch.Tensor | None = None, tf32: bool = False):
    """The illumination MLP: embedding [B, 32] -> (envlight SH [B, 25, 3], sky SH [B, 4, 3]).
    Trunk 256 (dropout keep-mask, scaled by 1 / 0.8) / 256 / 128, sky head, envlight
    head 128 -> 75."""
    lin = lambda i, x: M.linear(x, weights[f"dense.{i}.weight"], weights[f"dense.{i}.bias"], tf32)
    x = lin(0, e)
    if keep is not None:
        x = torch.where(keep, x / KEEP_PROB, 0.0)
    x = torch.relu(x)
    x = torch.relu(lin(1, x))
    base = torch.relu(lin(2, x))
    sky = lin(3, base)
    envl = lin(5, torch.relu(lin(4, base)))
    return envl.reshape(e.shape[0], -1, 3), sky.reshape(e.shape[0], -1, 3)


# ------------------------------------------------------------------ shading


def shade_colors(s: Splats, envl: torch.Tensor, sky_sh: torch.Tensor, campos: torch.Tensor,
                 fg_lut: torch.Tensor, envl_deg: int = 4, sky_deg: int = 1, tf32: bool = False,
                 aov: bool = False):
    """Per-Gaussian color [N, 3] (or, with `aov`, the 13 training channels: rgb,
    diffuse, specular, depth (zero), normal * 0.5 + 0.5)."""
    xyz = xyz_of(s)
    albedo, kr, km = torch.sigmoid(s.albedo), torch.sigmoid(s.roughness), torch.sigmoid(s.metalness)
    is_sky = s.is_sky[:, None]
    dir_n = M.safe_normalize_div(xyz - campos[None])
    R = M.quat_to_rotmat(M.safe_normalize(s.rotation))
    normal = M.flip_to_viewer(M.min_axis(torch.exp(s.scaling), R), dir_n)

    b = envl
    x, y, z = normal[..., 0, None], normal[..., 1, None], normal[..., 2, None]
    irr = (C1 * b[8] * (x ** 2 - y ** 2) + C3 * b[6] * z ** 2 + C4 * b[0] - C5 * b[6]
           + 2 * C1 * b[4] * x * y + 2 * C1 * b[7] * x * z + 2 * C1 * b[5] * y * z
           + 2 * C2 * b[3] * x + 2 * C2 * b[1] * y + 2 * C2 * b[2] * z)
    diffuse_hdr = albedo * torch.clamp_min(irr, 1e-4)
    wo = M.safe_normalize_div(campos[None] - xyz)
    refl = M.safe_normalize_div(2 * torch.sum(wo * normal, -1, keepdim=True) * normal - wo)
    ndotv = torch.clamp_min(torch.sum(wo * normal, dim=-1, keepdim=True), 1e-4)
    fg = LUT.sample_bilinear(fg_lut, torch.cat([ndotv, kr], dim=-1))
    k = M.sh_basis(envl_deg, refl) * M.gauss_kernel(kr, envl_deg)
    spec_irr = torch.clamp_min(M.mm(k, b[: k.shape[-1]], tf32), 1e-4)
    F0 = (1.0 - km) * 0.04 + albedo * km
    specular_hdr = spec_irr * (F0 * fg[..., 0:1] + fg[..., 1:2])
    shaded = M.gamma_correction((1 - km) * diffuse_hdr + specular_hdr)

    sky_rgb = torch.clamp_min(M.eval_sh(sky_deg, sky_sh.transpose(-1, -2), dir_n) + 0.5, 0.0)
    rgb = torch.where(is_sky, sky_rgb, shaded)
    if not aov:
        return rgb
    diffuse = torch.where(is_sky, 0.0, M.gamma_correction(diffuse_hdr))
    spec = torch.where(is_sky, 0.0, M.gamma_correction(specular_hdr))
    return torch.cat([rgb, diffuse, spec, torch.zeros_like(xyz[:, :1]), 0.5 * normal + 0.5], -1)


# ------------------------------------------------------------------ projection


class Projected(NamedTuple):
    mean2d: torch.Tensor    # [N, 2]
    conic: torch.Tensor     # [N, 3]
    depth: torch.Tensor     # [N]
    radius: torch.Tensor    # [N] int32
    counts: torch.Tensor    # [N] int32 tiles of the (opacity-tightened) rect
    rect_min: torch.Tensor  # [N, 2] int32
    rect_w: torch.Tensor    # [N] int32


def _row(p, Mx, i):
    return p[:, 0] * Mx[i, 0] + p[:, 1] * Mx[i, 1] + p[:, 2] * Mx[i, 2] + Mx[i, 3]


def _tfloor(x, tile, hi):
    return torch.clamp(torch.floor(x / tile), 0, hi).to(torch.int32)


def project(xyz, scales, quats, opacity, active, cam: Camera, tile: int = 16,
            skip_alpha: float = ALPHA_MIN) -> Projected:
    """EWA projection (+0.3 low-pass), conic, screen radius and the tile rect,
    tightened to where alpha can reach `skip_alpha`."""
    W, H = cam.width, cam.height
    tfx, tfy = cam.tan_fovx, cam.tan_fovy
    fx, fy = W / (2.0 * tfx), H / (2.0 * tfy)
    gx, gy = (W + tile - 1) // tile, (H + tile - 1) // tile
    v, P = cam.viewmat, cam.projmat
    z = _row(xyz, v, 2)
    front = z > 0.2
    inv_w = torch.where(front, 1.0 / (_row(xyz, P, 3) + 1e-7), 0.0)
    mean2d = torch.stack([M.ndc_to_pixel(_row(xyz, P, 0) * inv_w, W),
                          M.ndc_to_pixel(_row(xyz, P, 1) * inv_w, H)], dim=-1)
    cov3d = M.covariance_3d(scales, quats)

    t0, t1 = _row(xyz, v, 0), _row(xyz, v, 1)
    tz = torch.where(z > 0.2, z, 1.0)
    tx = torch.minimum(torch.maximum(t0 / tz, -1.3 * tfx), 1.3 * tfx) * tz
    ty = torch.minimum(torch.maximum(t1 / tz, -1.3 * tfy), 1.3 * tfy) * tz
    j00, j02 = fx / tz, -(fx * tx) / (tz * tz)
    j11, j12 = fy / tz, -(fy * ty) / (tz * tz)
    m00, m01, m02 = j00 * v[0, 0] + j02 * v[2, 0], j00 * v[0, 1] + j02 * v[2, 1], j00 * v[0, 2] + j02 * v[2, 2]
    m10, m11, m12 = j11 * v[1, 0] + j12 * v[2, 0], j11 * v[1, 1] + j12 * v[2, 1], j11 * v[1, 2] + j12 * v[2, 2]
    a, b, c, d, e, f = (cov3d[:, i] for i in range(6))
    v0x, v1x, v2x = a * m00 + b * m01 + c * m02, b * m00 + d * m01 + e * m02, c * m00 + e * m01 + f * m02
    v0y, v1y, v2y = a * m10 + b * m11 + c * m12, b * m10 + d * m11 + e * m12, c * m10 + e * m11 + f * m12
    cxx = m00 * v0x + m01 * v1x + m02 * v2x + 0.3
    cxy = m10 * v0x + m11 * v1x + m12 * v2x
    cyy = m10 * v0y + m11 * v1y + m12 * v2y + 0.3
    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], dim=-1)

    with torch.no_grad():
        mid = 0.5 * (cxx + cyy)
        disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(torch.maximum(mid + disc, mid - disc), 0.0)))
        mx, my = mean2d[:, 0], mean2d[:, 1]
        x0, y0 = _tfloor(mx - radius_f, tile, gx), _tfloor(my - radius_f, tile, gy)
        x1 = _tfloor(mx + radius_f + tile - 1, tile, gx)
        y1 = _tfloor(my + radius_f + tile - 1, tile, gy)
        alive = front & det_ok & ((x1 - x0) * (y1 - y0) > 0) & active
        radius = torch.where(alive, radius_f, 0.0).to(torch.int32)
        op = opacity[:, 0]
        tau = torch.sqrt(torch.clamp_min(
            2.0 * torch.log((1.0 / skip_alpha) * torch.clamp_min(op, 1e-12)), 0.0))
        bx = tau * torch.sqrt(torch.clamp_min(cxx, 0.0)) * 1.0001 + 0.5
        by = tau * torch.sqrt(torch.clamp_min(cyy, 0.0)) * 1.0001 + 0.5
        x0 = torch.maximum(x0, _tfloor(mx - bx, tile, gx))
        y0 = torch.maximum(y0, _tfloor(my - by, tile, gy))
        x1 = torch.minimum(x1, torch.clamp(torch.floor((mx + bx) / tile) + 1, 0, gx).to(torch.int32))
        y1 = torch.minimum(y1, torch.clamp(torch.floor((my + by) / tile) + 1, 0, gy).to(torch.int32))
        area = torch.clamp_min(x1 - x0, 0) * torch.clamp_min(y1 - y0, 0)
        counts = torch.where(alive & (op >= skip_alpha), area, 0).to(torch.int32)
        x0 = torch.minimum(x0, x1)
        y0 = torch.minimum(y0, y1)
        rect_w = torch.clamp_min(x1 - x0, 1).to(torch.int32)
    return Projected(mean2d, conic, z, radius, counts, torch.stack([x0, y0], -1), rect_w)


# ------------------------------------------------------------------ binning


class Bins(NamedTuple):
    gauss_id: torch.Tensor    # [E] int64 Gaussian of each sorted entry
    tile_start: torch.Tensor  # [T] int64
    tile_end: torch.Tensor    # [T] int64


def bin_entries(pr: Projected, grid_x: int, grid_y: int) -> Bins:
    """Every (Gaussian, tile) entry of the rects, sorted by (tile, depth rank);
    equal depths keep the Gaussians' order."""
    dev = pr.depth.device
    n = pr.depth.shape[0]
    counts = pr.counts.long()
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(pr.depth, stable=True)] = torch.arange(n, device=dev)
    g = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    offsets = torch.cumsum(counts, 0) - counts
    slot = torch.arange(g.shape[0], device=dev) - offsets[g]
    w = pr.rect_w[g].long()
    row = slot // w
    tile = (pr.rect_min[g, 1].long() + row) * grid_x + pr.rect_min[g, 0].long() + slot - row * w
    order = torch.argsort((tile << 32) | rank[g], stable=True)
    tile_sorted = tile[order]
    edges = torch.searchsorted(tile_sorted, torch.arange(grid_x * grid_y + 1, device=dev))
    return Bins(g[order], edges[:-1], edges[1:])


# ------------------------------------------------------------------ compositing


def _tile_batch(feat, starts, counts, tids, grid_x, tile, length):
    """alpha [B, L, P] of a batch of tiles and what the backward needs."""
    D = feat.shape[0]
    dev = feat.device
    lane = torch.arange(length, device=dev)
    idx = starts[:, None] + lane[None, :]
    valid = lane[None, :] < counts[:, None]
    rows = feat[torch.clamp(idx, 0, max(D - 1, 0))]
    tx0 = ((tids % grid_x) * tile).to(torch.float32)[:, None]
    ty0 = ((tids // grid_x) * tile).to(torch.float32)[:, None]
    mxl, myl = rows[..., 0] - tx0, rows[..., 1] - ty0
    ca, cb, cc = rows[..., 2], rows[..., 3], rows[..., 4]
    # power over tile-local pixels as f(px) + g(py) + qxy px py, in the op
    # order of the program's compositors (a skip or a termination decided on
    # rounding must fall the same way)
    q0 = (-0.5 * (ca * (mxl * mxl) + cc * (myl * myl)) - cb * (mxl * myl))[..., None]
    qx, qy = (ca * mxl + cb * myl)[..., None], (cc * myl + cb * mxl)[..., None]
    qxx, qyy, qxy = (-0.5 * ca)[..., None], (-0.5 * cc)[..., None], (-cb)[..., None]
    pv = torch.arange(tile, dtype=torch.float32, device=dev)
    pix = torch.arange(tile * tile, device=dev)
    pp = ((pix % tile) * (pix // tile)).to(torch.float32)
    fpx = (q0 + qx * pv + qxx * (pv * pv)).repeat(1, 1, tile)
    gpy = (qy * pv + qyy * (pv * pv)).repeat_interleave(tile, dim=-1)
    power = (fpx + gpy) + qxy * pp
    G = torch.exp(torch.clamp_max(power, 0.0))
    alpha_raw = torch.clamp_max(rows[..., 5:6] * G, ALPHA_SAT)
    skip = (power > 0.0) | (alpha_raw < ALPHA_MIN) | ~valid[..., None]
    alpha = torch.where(skip, 0.0, alpha_raw)
    return alpha, dict(rows=rows, idx=idx, valid=valid, G=G, skip=skip, tx0=tx0, ty0=ty0)


def _transmittance(alpha):
    one_m = 1.0 - alpha
    P_inc = torch.cumprod(one_m, dim=1)
    P_prev = torch.cat([torch.ones_like(P_inc[:, :1]), P_inc[:, :-1]], dim=1)
    include = P_inc >= T_EPS
    w = torch.where(include, alpha * P_prev, 0.0)
    T_fin = torch.prod(torch.where(include, one_m, 1.0), dim=1)
    return one_m, P_prev, include, w, T_fin


def tile_batches(counts: np.ndarray, per_tile: int, budget: int = 1 << 24):
    """Consecutive tile ranges [t0, t1) whose padded work stays within `budget`."""
    t0, T = 0, counts.shape[0]
    while t0 < T:
        t1, lmax = t0 + 1, max(int(counts[t0]), 1)
        while t1 < T:
            lnew = max(lmax, int(counts[t1]))
            if (t1 + 1 - t0) * lnew * per_tile > budget:
                break
            t1, lmax = t1 + 1, lnew
        yield t0, t1, lmax
        t0 = t1


def composite_forward(feat, tile_start, tile_end, bg, grid_x, tile: int = 16):
    """(tiles [T, P, C] with T_final * bg added, T_final [T, P])."""
    T, P, C = tile_start.shape[0], tile * tile, feat.shape[1] - 6
    out = torch.empty((T, P, C), dtype=torch.float32, device=feat.device)
    out_t = torch.empty((T, P), dtype=torch.float32, device=feat.device)
    counts = tile_end - tile_start
    for t0, t1, length in tile_batches(counts.cpu().numpy(), P):
        tids = torch.arange(t0, t1, device=feat.device)
        alpha, aux = _tile_batch(feat, tile_start[t0:t1], counts[t0:t1], tids, grid_x, tile, length)
        _, _, _, w, T_fin = _transmittance(alpha)
        colors = aux["rows"][..., 6:]
        color = torch.stack([(w * colors[..., c:c + 1]).sum(dim=1) for c in range(C)], dim=-1)
        out[t0:t1] = color + T_fin[..., None] * bg
        out_t[t0:t1] = T_fin
    return out, out_t


def composite_backward(feat, tile_start, tile_end, bg, grid_x, g_tiles, g_tfin, tile: int = 16):
    """Closed-form gradients (d_feat [D, 6 + C], d_bg [C]); the saturation of
    alpha at 0.99 is not masked, as in the reference rasterizer."""
    P, C = tile * tile, feat.shape[1] - 6
    dev = feat.device
    d_feat = torch.zeros_like(feat)
    d_bg = torch.zeros((C,), dtype=torch.float32, device=dev)
    counts = tile_end - tile_start
    for t0, t1, length in tile_batches(counts.cpu().numpy(), P):
        tids = torch.arange(t0, t1, device=dev)
        alpha, aux = _tile_batch(feat, tile_start[t0:t1], counts[t0:t1], tids, grid_x, tile, length)
        one_m, P_prev, include, w, T_fin = _transmittance(alpha)
        rows = aux["rows"]
        colors = rows[..., 6:]
        gbar = g_tiles[t0:t1]
        cdotg = colors[..., 0:1] * gbar[:, None, :, 0]
        for c in range(1, C):
            cdotg = cdotg + colors[..., c:c + 1] * gbar[:, None, :, c]
        Q = torch.cumsum(w * cdotg, dim=1)
        S = Q[:, -1:] - Q
        Bv = gbar[..., 0] * bg[0]
        for c in range(1, C):
            Bv = Bv + gbar[..., c] * bg[c]
        Bv = Bv + g_tfin[t0:t1]
        contrib = include & ~aux["skip"]
        d_alpha = torch.where(contrib, P_prev * cdotg - (S + (T_fin * Bv)[:, None, :]) / one_m, 0.0)
        G = aux["G"]
        dG = rows[..., 5:6] * d_alpha
        pix = torch.arange(P, device=dev)
        px = aux["tx0"] + (pix % tile).to(torch.float32)
        py = aux["ty0"] + (pix // tile).to(torch.float32)
        dx = rows[..., 0:1] - px[:, None, :]
        dy = rows[..., 1:2] - py[:, None, :]
        gdx, gdy = G * dx, G * dy
        ca, cb, cc = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5]
        d_rows = torch.stack([
            torch.sum(dG * (-(gdx * ca + gdy * cb)), dim=-1),
            torch.sum(dG * (-(gdy * cc + gdx * cb)), dim=-1),
            torch.sum(-0.5 * gdx * dx * dG, dim=-1),
            torch.sum(-(gdx * dy) * dG, dim=-1),
            torch.sum(-0.5 * gdy * dy * dG, dim=-1),
            torch.sum(G * d_alpha, dim=-1),
        ] + [torch.sum(w * gbar[:, None, :, c], dim=-1) for c in range(C)], dim=-1)
        valid = aux["valid"]
        d_feat[aux["idx"][valid]] = d_rows[valid]
        d_bg += torch.sum(T_fin[..., None] * gbar, dim=(0, 1))
    return d_feat, d_bg


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, tile_start, tile_end, bg, grid_x):
        out, tfin = composite_forward(feat, tile_start, tile_end, bg, grid_x)
        ctx.save_for_backward(feat, tile_start, tile_end, bg)
        ctx.grid_x = grid_x
        return out, tfin

    @staticmethod
    def backward(ctx, g_out, g_tfin):
        feat, ts, te, bg = ctx.saved_tensors
        d_feat, d_bg = composite_backward(feat, ts, te, bg, ctx.grid_x, g_out.contiguous(),
                                          g_tfin.contiguous())
        return d_feat, None, None, d_bg, None


# ------------------------------------------------------------------ rasterizer


class Raster(NamedTuple):
    image: torch.Tensor    # [H, W, C]
    alpha: torch.Tensor    # [H, W] 1 - T_final
    radii: torch.Tensor    # [N] int32
    depth: torch.Tensor    # [N] view z
    entries: int


def rasterize(xyz, scales, quats, opacity, colors, bg, active, cam: Camera, mean2d_probe=None,
              skip_alpha: float = ALPHA_MIN, tile: int = 16) -> Raster:
    """Composite colors [N, C] of the Gaussians over bg [C]."""
    W, H = cam.width, cam.height
    gx, gy = (W + tile - 1) // tile, (H + tile - 1) // tile
    pr = project(xyz, scales, quats, opacity, active, cam, tile, skip_alpha)
    bins = bin_entries(pr, gx, gy)
    mean2d = pr.mean2d if mean2d_probe is None else pr.mean2d + mean2d_probe
    rows = torch.cat([mean2d, pr.conic, opacity, colors], dim=-1)[bins.gauss_id]
    tiles, tfin = _Composite.apply(rows, bins.tile_start, bins.tile_end, bg, gx)
    C = colors.shape[-1]
    img = tiles.reshape(gy, gx, tile, tile, C).permute(0, 2, 1, 3, 4).reshape(gy * tile, gx * tile, C)
    tf = tfin.reshape(gy, gx, tile, tile).permute(0, 2, 1, 3).reshape(gy * tile, gx * tile)
    return Raster(img[:H, :W], 1.0 - tf[:H, :W], pr.radius, pr.depth, int(bins.gauss_id.shape[0]))


def render_rgb_u8(s: Splats, weights: dict, emb: torch.Tensor, cam: Camera, fg_lut,
                  bg=None, tf32: bool = False) -> torch.Tensor:
    """A served frame: [H, W, 3] uint8, the truncating cast of the clamped image."""
    with torch.no_grad():
        envl, sky = mlp(weights, emb[None], tf32=tf32)
        rgb = shade_colors(s, envl[0], sky, cam.campos, fg_lut, tf32=tf32)
        scales, quats = torch.exp(s.scaling), M.safe_normalize(s.rotation)
        bg = torch.zeros(3, device=rgb.device) if bg is None else bg
        r = rasterize(xyz_of(s), scales, quats, opacity_of(s), rgb, bg, s.alive, cam)
        return (torch.clamp(r.image, 0.0, 1.0) * 255.0).to(torch.uint8)
