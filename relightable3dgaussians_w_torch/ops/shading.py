"""The per-Gaussian shading as one differentiable operation over the pool's
rows: `shade_rows`, which `renderer.compute_colors` calls.

On the card its forward and backward are the kernels of `csrc/shade.cu`
(`ops/cuda/shade.py`). On the CPU its forward is `shade_rows_plain`, the
unchanged chain (models/light.py `shade`, utils/sh.py, ops/texture.py
`bilinear_sample_packed`), and its backward `shade_rows_backward_plain`, the
analytic gradient written from the same derivation as the backward kernel,
step for step, so that the CPU tests against autograd and the JAX package
hold the derivation the kernel runs. Neither direction saves anything but the
inputs.

Channel layouts: renderer.py's module docstring (3, 13 or 21 channels).
Inputs are the raw leaves (rotation, scaling, albedo, roughness and
metalness before their activations), the merged positions `G.get_xyz` gives
(the sky's polar map stays in autograd, outside), `is_sky`, the envlight SH
[(env_deg+1)**2, 3], the sky SH ((sky_deg+1)**2 x 3 values, the MLP's
[1, K, 3]), the camera position and, optionally, the
view matrix's third row, which fills the depth channel. Gradients flow to
xyz, rotation, albedo, roughness, metalness, the envlight and the sky SH;
scaling has none (the smallest-axis choice is a comparison), and the camera
and the view row are constants of the shading.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import light as L
from ..utils.general import flip_align_view, get_minimum_axis
from ..utils.graphics import quat_to_rotmat, safe_normalize as quat_normalize
from ..utils.sh import C1, C2, C3, C4, C5, band_index_per_coeff, eval_sh, gauss_kernel, sh_basis
from .cuda import shade as shade_kernel

EPS = 1e-20      # safe_normalize's floor of |x|^2
FLOOR = 1e-4     # the irradiance, specular irradiance and n.v floors
LUT = 256        # the FG LUT's size (models/brdf_lut.py)
GAMMA = 1.0 / 2.2


class ShadeOptions(NamedTuple):
    env_deg: int
    sky_deg: int
    channels: int       # 3, 13 or 21
    specular: bool
    fix_sky: bool
    normals: bool       # also return the normals [N, 3]


def shade_rows_plain(xyz, rotation, scaling, albedo, roughness, metalness, is_sky, base, sky_sh,
                     campos, view_row, opts: ShadeOptions):
    """The shading chain in plain PyTorch: (colors [N, C], normals [N, 3])."""
    albedo = torch.sigmoid(albedo)
    kr = torch.sigmoid(roughness)
    km = torch.sigmoid(metalness)
    is_sky = is_sky[:, None]

    dir_pp = xyz - campos[None, :]
    dir_pp_n = L.safe_normalize(dir_pp)
    normal = get_minimum_axis(torch.exp(scaling), quat_to_rotmat(quat_normalize(rotation)))
    normal, _ = flip_align_view(normal, dir_pp_n)

    shaded = L.shade(base, opts.env_deg, xyz, normal, albedo, campos, kr, km,
                     specular=opts.specular)

    if opts.fix_sky:
        sky_rgb = torch.ones_like(xyz)
    else:
        sky_sh2rgb = eval_sh(opts.sky_deg, sky_sh.transpose(-1, -2), dir_pp_n)
        sky_rgb = torch.clamp_min(sky_sh2rgb + 0.5, 0.0)

    rgb = torch.where(is_sky, sky_rgb, shaded.rgb)
    if opts.channels == 3:
        return rgb, normal
    diffuse = torch.where(is_sky, 0.0, shaded.diffuse)
    spec = torch.where(is_sky, 0.0, shaded.specular)
    if view_row is None:
        depth_feat = torch.zeros_like(xyz[:, :1])
    else:
        v = view_row
        depth_feat = (xyz[:, 0] * v[0] + xyz[:, 1] * v[1] + xyz[:, 2] * v[2] + v[3])[:, None]
    normal_feat = 0.5 * normal + 0.5
    channels = [rgb, diffuse, spec, depth_feat, normal_feat]
    if opts.channels == 21:
        channels += [
            torch.where(is_sky, sky_rgb, 0.0),
            torch.where(is_sky, 0.0, kr),
            torch.where(is_sky, 0.0, km),
            torch.where(is_sky, torch.ones_like(albedo), albedo),
        ]
    return torch.cat(channels, dim=-1), normal


# ------------------------------------------------------------------ backward


def sh_basis_vjp(deg: int, dirs: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """sum_i g[..., i] * grad sh_basis_i(dirs): [..., 3]. The basis's
    polynomials (utils/sh.py) differentiated term by term, as
    csrc/shade.cu `sh_basis_vjp`."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    gx, gy, gz = torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(x)
    if deg > 0:
        gy = gy - C1 * g[..., 1]
        gz = gz + C1 * g[..., 2]
        gx = gx - C1 * g[..., 3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        terms = [
            (C2[0], 4, y, x, None),
            (C2[1], 5, None, z, y),
            (C2[2], 6, -2 * x, -2 * y, 4 * z),
            (C2[3], 7, z, None, x),
            (C2[4], 8, 2 * x, -2 * y, None),
        ]
        if deg > 2:
            terms += [
                (C3[0], 9, 6 * xy, 3 * xx - 3 * yy, None),
                (C3[1], 10, yz, xz, xy),
                (C3[2], 11, -2 * xy, 4 * zz - xx - 3 * yy, 8 * yz),
                (C3[3], 12, -6 * xz, -6 * yz, 6 * zz - 3 * xx - 3 * yy),
                (C3[4], 13, 4 * zz - 3 * xx - yy, -2 * xy, 8 * xz),
                (C3[5], 14, 2 * xz, -2 * yz, xx - yy),
                (C3[6], 15, 3 * xx - 3 * yy, -6 * xy, None),
            ]
        if deg > 3:
            terms += [
                (C4[0], 16, y * (3 * xx - yy), x * (xx - 3 * yy), None),
                (C4[1], 17, 6 * xy * z, z * (3 * xx - 3 * yy), y * (3 * xx - yy)),
                (C4[2], 18, y * (7 * zz - 1), x * (7 * zz - 1), 14 * xy * z),
                (C4[3], 19, None, z * (7 * zz - 3), y * (21 * zz - 3)),
                (C4[4], 20, None, None, z * (140 * zz - 60)),
                (C4[5], 21, z * (7 * zz - 3), None, x * (21 * zz - 3)),
                (C4[6], 22, 2 * x * (7 * zz - 1), -2 * y * (7 * zz - 1), 14 * z * (xx - yy)),
                (C4[7], 23, z * (3 * xx - 3 * yy), -6 * xy * z, x * (xx - 3 * yy)),
                (C4[8], 24, 4 * x * (xx - 3 * yy), 4 * y * (yy - 3 * xx), None),
            ]
        if deg > 4:
            terms += [
                (C5[0], 25, 20 * xy * (xx - yy), 5 * xx * xx - 30 * xx * yy + 5 * yy * yy, None),
                (C5[1], 26, yz * (3 * xx - yy), xz * (xx - 3 * yy), xy * (xx - yy)),
                (C5[2], 27, 6 * xy * (9 * zz - 1), (9 * zz - 1) * (3 * xx - 3 * yy),
                 18 * yz * (3 * xx - yy)),
                (C5[3], 28, yz * (3 * zz - 1), xz * (3 * zz - 1), xy * (9 * zz - 1)),
                (C5[4], 29, None, zz * (-14 + 21 * zz) + 1, yz * (84 * zz - 28)),
                (C5[5], 30, None, None, zz * (315 * zz - 210) + 15),
                (C5[6], 31, zz * (21 * zz - 14) + 1, None, xz * (84 * zz - 28)),
                (C5[7], 32, 2 * xz * (3 * zz - 1), -2 * yz * (3 * zz - 1),
                 (xx - yy) * (9 * zz - 1)),
                (C5[8], 33, (9 * zz - 1) * (3 * xx - 3 * yy), (9 * zz - 1) * -6 * xy,
                 18 * xz * (xx - 3 * yy)),
                (C5[9], 34, 4 * xz * (xx - 3 * yy), 4 * yz * (yy - 3 * xx),
                 xx * (xx - 6 * yy) + yy * yy),
                (C5[10], 35, 5 * xx * xx - 30 * xx * yy + 5 * yy * yy, 20 * xy * (yy - xx), None),
            ]
        for const, i, dx, dy, dz in terms:
            c = const * g[..., i]
            if dx is not None:
                gx = gx + c * dx
            if dy is not None:
                gy = gy + c * dy
            if dz is not None:
                gz = gz + c * dz
    return torch.stack([gx, gy, gz], dim=-1)


def _gamma_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx utils/sh.py `gamma_correction` (clamp passes at equality)."""
    inside = (x >= 0.0) & (x <= 1.0)
    return torch.where(inside, GAMMA * (torch.clamp(x, 0.0, 1.0) + 1e-4) ** (GAMMA - 1.0), 0.0)


def _rot_column(q: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """Column ax [N, 1] of the rotation matrix of the unit quaternions q [N, 4]
    (utils/graphics.py `_rotmat_entries`)."""
    r, x, y, z = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    col0 = torch.cat([1 - 2 * (y * y + z * z), 2 * (x * y + r * z), 2 * (x * z - r * y)], -1)
    col1 = torch.cat([2 * (x * y - r * z), 1 - 2 * (x * x + z * z), 2 * (y * z + r * x)], -1)
    col2 = torch.cat([2 * (x * z + r * y), 2 * (y * z - r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.where(ax == 0, col0, torch.where(ax == 1, col1, col2))


def _rot_column_vjp(q: torch.Tensor, ax: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(d column_ax(R(q)) / d q)^T g for the unit quaternions q [N, 4] (w, x, y,
    z), columns ax [N, 1] and cotangents g [N, 3] -> [N, 4]."""
    r, x, y, z = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    a, b, c = g[:, 0:1], g[:, 1:2], g[:, 2:3]
    col0 = torch.cat([2 * (z * b - y * c), 2 * (y * b + z * c),
                      -4 * y * a + 2 * (x * b - r * c), -4 * z * a + 2 * (r * b + x * c)], -1)
    col1 = torch.cat([2 * (x * c - z * a), 2 * (y * a + r * c) - 4 * x * b,
                      2 * (x * a + z * c), 2 * (y * c - r * a) - 4 * z * b], -1)
    col2 = torch.cat([2 * (y * a - x * b), 2 * (z * a - r * b) - 4 * x * c,
                      2 * (r * a + z * b) - 4 * y * c, 2 * (x * a + y * b)], -1)
    return torch.where(ax == 0, col0, torch.where(ax == 1, col1, col2))


def _irradiance_vjp_normal(base, n, gI):
    """(d I / d n)^T gI for models/light.py `diffuse_irradiance` I [N, 3]."""
    C1, C2, C3 = L.C1, L.C2, L.C3
    x, y, z = n[:, 0:1], n[:, 1:2], n[:, 2:3]
    b = base
    gx = gI * (2 * C1 * b[8] * x + 2 * C1 * b[4] * y + 2 * C1 * b[7] * z + 2 * C2 * b[3])
    gy = gI * (-2 * C1 * b[8] * y + 2 * C1 * b[4] * x + 2 * C1 * b[5] * z + 2 * C2 * b[1])
    gz = gI * (2 * C3 * b[6] * z + 2 * C1 * b[7] * x + 2 * C1 * b[5] * y + 2 * C2 * b[2])
    return torch.cat([gx.sum(-1, keepdim=True), gy.sum(-1, keepdim=True),
                      gz.sum(-1, keepdim=True)], -1)


def _irradiance_vjp_base(n, gI):
    """(d I / d base)^T gI, summed over the rows: [9, 3]."""
    C1, C2, C3, C4, C5 = L.C1, L.C2, L.C3, L.C4, L.C5
    x, y, z = n[:, 0:1], n[:, 1:2], n[:, 2:3]
    coeff = torch.cat([torch.full_like(x, C4), 2 * C2 * y, 2 * C2 * z, 2 * C2 * x,
                       2 * C1 * x * y, 2 * C1 * y * z, C3 * (z * z) - C5, 2 * C1 * x * z,
                       C1 * (x * x - y * y)], -1)
    return torch.sum(coeff[:, :, None] * gI[:, None, :], dim=0)


def shade_rows_backward_plain(xyz, rotation, scaling, albedo, roughness, metalness, is_sky, base,
                              sky_sh, campos, view_row, opts: ShadeOptions, g_out, g_normals):
    """The analytic gradient of `shade_rows_plain`: (d_xyz, d_rotation,
    d_albedo, d_roughness, d_metalness, d_envlight, d_sky_sh), recomputing the
    forward from the inputs. Torch's sub-gradients: clamp and clamp_min pass
    at equality, floor passes none, a where gives its unselected branch none."""
    C = g_out.shape[1]
    debug = C == 21
    sky = is_sky[:, None]
    fg = ~sky
    ke, ks = (opts.env_deg + 1) ** 2, (opts.sky_deg + 1) ** 2
    alb, kr, km = torch.sigmoid(albedo), torch.sigmoid(roughness), torch.sigmoid(metalness)
    # The geometry: dir_pp_n, both normalizations of the quaternion, the
    # smallest axis, the flip.
    d = xyz - campos[None, :]
    sd = torch.sum(d * d, dim=-1, keepdim=True)
    dden = torch.sqrt(torch.clamp_min(sd, EPS))
    dn = d / dden
    q = rotation
    sq1 = torch.sum(q * q, dim=-1, keepdim=True)
    rs1 = torch.rsqrt(torch.clamp_min(sq1, EPS))
    q1 = q * rs1
    sq2 = torch.sum(q1 * q1, dim=-1, keepdim=True)
    rs2 = torch.rsqrt(torch.clamp_min(sq2, EPS))
    qn = q1 * rs2
    e = torch.exp(scaling)
    first01 = e[:, 0:1] <= e[:, 1:2]
    ax = torch.where(torch.where(first01, e[:, 0:1], e[:, 1:2]) <= e[:, 2:3],
                     torch.where(first01, 0, 1), 2)
    n0 = _rot_column(qn, ax)
    flip = torch.where(torch.sum(n0 * -dn, dim=-1, keepdim=True) >= 0, 1.0, -1.0)
    n = flip * n0

    g = g_out
    gf = torch.where(fg, g, 0.0)     # the foreground branch's cotangents
    gn = 0.5 * g[:, 10:13] if C > 3 else torch.zeros_like(n)
    if g_normals is not None:
        gn = gn + g_normals
    gdn = torch.zeros_like(dn)
    ga = gf[:, 18:21] if debug else torch.zeros_like(alb)
    gkr = gf[:, 16:17] if debug else torch.zeros_like(kr)
    gkm = gf[:, 17:18] if debug else torch.zeros_like(km)
    d_base = torch.zeros_like(base)
    d_sky = torch.zeros_like(sky_sh)

    # Sky rows: the sky SH colour, clamped at 0.
    if not opts.fix_sky:
        shs = sky_sh.reshape(ks, 3)
        Ys = sh_basis(opts.sky_deg, dn)
        E = torch.sum(Ys[:, :, None] * shs[None], dim=1) + 0.5
        gs = g[:, 0:3] + g[:, 13:16] if debug else g[:, 0:3]
        gE = torch.where(sky & (E >= 0.0), gs, 0.0)
        d_sky = torch.sum(Ys[:, :, None] * gE[:, None, :], dim=0).reshape(sky_sh.shape)
        gY = torch.sum(gE[:, None, :] * shs[None], dim=-1)
        gdn = gdn + sh_basis_vjp(opts.sky_deg, dn, gY)

    # Foreground rows: diffuse, and the split-sum specular.
    I = L.diffuse_irradiance(base, n)
    irr = torch.clamp_min(I, FLOOR)
    D = alb * irr
    if opts.specular:
        wo = -dn
        dv = torch.sum(wo * n, dim=-1, keepdim=True)
        r = 2 * dv * n - wo
        sr = torch.sum(r * r, dim=-1, keepdim=True)
        rden = torch.sqrt(torch.clamp_min(sr, EPS))
        refl = r / rden
        ndotv = torch.clamp_min(dv, FLOOR)
        u = ndotv * LUT - 0.5
        v = kr * LUT - 0.5
        u0, v0 = torch.floor(u), torch.floor(v)
        fu = torch.where(u0 < 0, 0.0, u - u0)
        fv = torch.where(v0 < 0, 0.0, v - v0)
        lut = L._fg_lut_quad_on(xyz.device)
        tex = lut[torch.clamp(v0.long(), 0, LUT - 1)[:, 0],
                  torch.clamp(u0.long(), 0, LUT - 1)[:, 0]]
        t00, t01, t10, t11 = tex[:, 0:2], tex[:, 2:4], tex[:, 4:6], tex[:, 6:8]
        fgv = t00 * (1 - fu) * (1 - fv) + t01 * fu * (1 - fv) + t10 * (1 - fu) * fv + t11 * fu * fv
        fg0, fg1 = fgv[:, 0:1], fgv[:, 1:2]
        Y = sh_basis(opts.env_deg, refl)
        gk = gauss_kernel(kr, opts.env_deg)
        K3 = torch.sum((Y * gk)[:, :, None] * base[None, :ke], dim=1)
        si = torch.clamp_min(K3, FLOOR)
        F0 = (1.0 - km) * 0.04 + alb * km
        rf = F0 * fg0 + fg1
        S = si * rf
        H = (1 - km) * D + S
        gH = gf[:, 0:3] * _gamma_grad(H)
        gS = (gf[:, 6:9] * _gamma_grad(S) if C > 3 else 0.0) + gH
        gD = (gf[:, 3:6] * _gamma_grad(D) if C > 3 else 0.0) + gH * (1 - km)
        gkm = gkm + torch.sum(-gH * D, dim=-1, keepdim=True)
        grf = gS * si
        gF0 = grf * fg0
        gfg0 = torch.sum(grf * F0, dim=-1, keepdim=True)
        gfg1 = torch.sum(grf, dim=-1, keepdim=True)
        gkm = gkm + torch.sum(gF0 * (alb - 0.04), dim=-1, keepdim=True)
        ga = ga + gF0 * km
        gK = torch.where(K3 >= FLOOR, gS * rf, 0.0)
        # The contraction and the band factor exp(-l(l+1) * 0.3 * kr).
        d_base = d_base + torch.sum((Y * gk)[:, :, None] * gK[:, None, :], dim=0)
        gkk = torch.sum(gK[:, None, :] * base[None, :ke], dim=-1)
        gY = gkk * gk
        l = torch.as_tensor(band_index_per_coeff(opts.env_deg), dtype=kr.dtype, device=kr.device)
        gkr = gkr + torch.sum(gkk * Y * gk * (-(l * (l + 1.0)) * 0.3), dim=-1, keepdim=True)
        grefl = sh_basis_vjp(opts.env_deg, refl, gY)
        # refl = r / sqrt(max(|r|^2, eps)); r = 2 (wo . n) n - wo
        mr = torch.where(sr >= EPS, torch.sum(grefl * r, dim=-1, keepdim=True) / rden ** 3, 0.0)
        gr = grefl / rden - r * mr
        gdv = 2 * torch.sum(gr * n, dim=-1, keepdim=True)
        gn = gn + 2 * dv * gr
        gwo = -gr
        # The LUT's fractions carry the gradient of n.v and of the roughness.
        gfu = torch.sum(torch.cat([gfg0, gfg1], -1) * ((t01 - t00) * (1 - fv) + (t11 - t10) * fv),
                        dim=-1, keepdim=True)
        gfv = torch.sum(torch.cat([gfg0, gfg1], -1) * ((t10 - t00) * (1 - fu) + (t11 - t01) * fu),
                        dim=-1, keepdim=True)
        gndotv = torch.where(u0 >= 0, gfu * LUT, 0.0)
        gkr = gkr + torch.where(v0 >= 0, gfv * LUT, 0.0)
        gdv = gdv + torch.where(dv >= FLOOR, gndotv, 0.0)
        gwo = gwo + gdv * n
        gn = gn + gdv * wo
        gdn = gdn - gwo
    else:
        gD = (gf[:, 0:3] + gf[:, 3:6] if C > 3 else gf[:, 0:3]) * _gamma_grad(D)
    # D = albedo * max(I, 1e-4), I the degree-2 irradiance of the normal.
    ga = ga + gD * irr
    gI = torch.where(I >= FLOOR, gD * alb, 0.0)
    gn = gn + _irradiance_vjp_normal(base, n, gI)
    d_base[:9] += _irradiance_vjp_base(n, gI)

    # The sigmoids.
    d_albedo = ga * (1 - alb) * alb
    d_roughness = gkr * (1 - kr) * kr
    d_metalness = gkm * (1 - km) * km
    # The normal: the flip, the rotation column, both normalizations.
    gq = _rot_column_vjp(qn, ax, flip * gn)
    gq1 = gq * rs2 - q1 * torch.where(sq2 >= EPS, torch.sum(gq * q1, -1, keepdim=True) * rs2 ** 3,
                                      0.0)
    d_rotation = gq1 * rs1 - q * torch.where(sq1 >= EPS,
                                             torch.sum(gq1 * q, -1, keepdim=True) * rs1 ** 3, 0.0)
    # dir_pp_n = d / sqrt(max(|d|^2, eps)), d = xyz - campos; and the depth channel.
    m = torch.where(sd >= EPS, torch.sum(gdn * d, dim=-1, keepdim=True) / dden ** 3, 0.0)
    d_xyz = gdn / dden - d * m
    if view_row is not None and C > 3:
        d_xyz = d_xyz + g[:, 9:10] * view_row[None, :3]
    return d_xyz, d_rotation, d_albedo, d_roughness, d_metalness, d_base, d_sky


# ------------------------------------------------------------------ the operation


class _ShadeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, rotation, scaling, albedo, roughness, metalness, is_sky, base, sky_sh,
                campos, view_row, opts):
        ctx.set_materialize_grads(False)
        ctx.opts = opts
        ctx.save_for_backward(xyz, rotation, scaling, albedo, roughness, metalness, is_sky, base,
                              sky_sh, campos, view_row)
        if xyz.is_cuda:
            colors, normals = shade_kernel.shade_forward(
                _kernel_rows(xyz, rotation, scaling, albedo, roughness, metalness, is_sky),
                base.contiguous(), sky_sh.reshape(-1, 3).contiguous(), campos.contiguous(),
                None if view_row is None else view_row.contiguous(),
                L._fg_lut_quad_on(xyz.device), opts.env_deg, opts.sky_deg, opts.channels,
                opts.specular, opts.fix_sky, opts.normals)
        else:
            colors, normals = shade_rows_plain(xyz, rotation, scaling, albedo, roughness,
                                               metalness, is_sky, base, sky_sh, campos,
                                               view_row, opts)
        return (colors, normals) if opts.normals else colors

    @staticmethod
    def backward(ctx, g_colors, g_normals=None):
        inputs = ctx.saved_tensors
        xyz, base, sky_sh, view_row = inputs[0], inputs[7], inputs[8], inputs[10]
        opts = ctx.opts
        if g_colors is None:
            g_colors = torch.zeros((xyz.shape[0], opts.channels), dtype=xyz.dtype,
                                   device=xyz.device)
        with torch.profiler.record_function("renderer.shading_backward"):
            if xyz.is_cuda:
                grads = shade_kernel.shade_backward(
                    _kernel_rows(*inputs[:7]), base.contiguous(),
                    sky_sh.reshape(-1, 3).contiguous(), inputs[9].contiguous(),
                    None if view_row is None else view_row.contiguous(),
                    L._fg_lut_quad_on(xyz.device), opts.env_deg, opts.sky_deg, opts.specular,
                    opts.fix_sky, g_colors.contiguous(),
                    None if g_normals is None else g_normals.contiguous())
                grads = grads[:6] + (grads[6].reshape(sky_sh.shape),)
            else:
                grads = shade_rows_backward_plain(*inputs, opts, g_colors, g_normals)
        d_xyz, d_rot, d_alb, d_rough, d_metal, d_base, d_sky = grads
        return (d_xyz, d_rot, None, d_alb, d_rough, d_metal, None, d_base, d_sky, None, None,
                None)


def _kernel_rows(xyz, rotation, scaling, albedo, roughness, metalness, is_sky):
    return tuple(t.contiguous() for t in (xyz, rotation, scaling, albedo, roughness, metalness,
                                          is_sky))


def shade_rows(xyz, rotation, scaling, albedo, roughness, metalness, is_sky, base, sky_sh,
               campos, view_row, opts: ShadeOptions):
    """The shaded feature channels of every row: (colors [N, opts.channels],
    normals [N, 3] or None without opts.normals). The kernels on the card,
    the plain chain and its analytic gradient on the CPU.

    Args:
        xyz: [N, 3] merged positions; rotation [N, 4], scaling [N, 3], albedo
            [N, 3], roughness [N, 1], metalness [N, 1]: the raw leaves;
            is_sky: [N] bool.
        base: [(env_deg+1)**2, 3] envlight SH; sky_sh: [..., (sky_deg+1)**2,
            3] ([1, K, 3] from the MLP); campos: [3].
        view_row: the view matrix's third row [4], which fills the depth
            channel (9), or None (the channel stays 0).
    """
    if opts.channels not in shade_kernel.LAYOUTS:
        raise ValueError(f"shade_rows: {opts.channels} channels; the layouts are "
                         f"{shade_kernel.LAYOUTS}")
    ke, ks = (opts.env_deg + 1) ** 2, (opts.sky_deg + 1) ** 2
    if tuple(base.shape) != (ke, 3) or sky_sh.numel() != ks * 3 or sky_sh.shape[-1] != 3:
        raise ValueError(f"shade_rows: the envlight must be [{ke}, 3] and the sky SH hold "
                         f"{ks} x 3 values (degrees {opts.env_deg}, {opts.sky_deg}); got "
                         f"{list(base.shape)}, {list(sky_sh.shape)}")
    if campos.requires_grad or (view_row is not None and view_row.requires_grad):
        raise ValueError("shade_rows: the camera position and the view row are constants of "
                         "the shading (no gradient flows to them)")
    out = _ShadeRows.apply(xyz, rotation, scaling, albedo, roughness, metalness, is_sky, base,
                           sky_sh, campos, view_row, opts)
    return out if opts.normals else (out, None)
