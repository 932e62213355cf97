"""The shading operation of the port (`ops/shading.py`) on the CPU: its plain
analytic backward, which the backward kernel (`csrc/shade.cu`) follows step for
step, against `torch.autograd.grad` of the plain chain; and `compute_colors`
against the chain it ran before the operation existed (the same values, bit
for bit, and the same gradients up to float32 rounding).

The derivation is held in float64 (the analytic gradient and autograd's agree
to ~1e-13 there, so a wrong term shows at once); in float32 the two orders of
rounding differ by up to ~5e-5 of a leaf's largest gradient (the gamma
correction's slope near its 1e-4 offset, ~68, magnifies the rounding of a
near-zero colour), held at 2e-4.
"""

import pytest
import torch

from relightable3dgaussians_w_torch import renderer
from relightable3dgaussians_w_torch.models import gaussians as G
from relightable3dgaussians_w_torch.models import light as L
from relightable3dgaussians_w_torch.ops import shading as S
from relightable3dgaussians_w_torch.ops.cuda import shade as shade_kernel
from relightable3dgaussians_w_torch.utils.sh import eval_sh

from _shade_rows import CAMPOS, VIEW_ROW, lighting, random_rows, rel_err
import _torch_threads

_torch_threads.share_cores()

F32_TOL = 2e-4
F64_TOL = 1e-9
LEAVES = ("xyz", "rotation", "albedo", "roughness", "metalness", "envlight", "sky_sh")


def _grads_both_ways(env_deg, sky_deg, channels, specular, fix_sky, dtype, n=300):
    rows = random_rows(n, seed=10 * env_deg + sky_deg)
    rows = tuple(r.to(dtype) if r.dtype.is_floating_point else r for r in rows)
    base, sky = (t.to(dtype) for t in lighting(env_deg, sky_deg, seed=channels))
    campos = torch.tensor(CAMPOS, dtype=dtype)
    view_row = torch.tensor(VIEW_ROW, dtype=dtype) if channels > 3 else None
    opts = S.ShadeOptions(env_deg, sky_deg, channels, specular, fix_sky, True)
    xyz, rot, scl, alb, rough, met, is_sky = rows
    leaves = [t.clone().requires_grad_(True) for t in (xyz, rot, alb, rough, met, base, sky)]
    x, r, a, ro, m, b, s = leaves
    colors, normals = S.shade_rows_plain(x, r, scl, a, ro, m, is_sky, b, s, campos, view_row, opts)
    g = torch.Generator().manual_seed(channels)
    g_colors = torch.randn(colors.shape, generator=g).to(dtype)
    g_normals = torch.randn(normals.shape, generator=g).to(dtype)
    want = torch.autograd.grad((colors * g_colors).sum() + (normals * g_normals).sum(), leaves,
                               allow_unused=True)
    got = S.shade_rows_backward_plain(xyz, rot, scl, alb, rough, met, is_sky, base, sky, campos,
                                      view_row, opts, g_colors, g_normals)
    return got, [torch.zeros_like(t) if w is None else w for w, t in zip(want, leaves)]


@pytest.mark.parametrize("specular, fix_sky", [(True, False), (False, False), (True, True)])
@pytest.mark.parametrize("channels", [3, 13, 21])
@pytest.mark.parametrize("env_deg, sky_deg", [(4, 1), (2, 0), (3, 2), (5, 5)])
def test_plain_backward_matches_autograd(env_deg, sky_deg, channels, specular, fix_sky):
    """Every leaf's gradient, with the normals' cotangent too, on random rows
    and the edge rows (`_shade_rows.edge_rows`)."""
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
        got, want = _grads_both_ways(env_deg, sky_deg, channels, specular, fix_sky, dtype)
        for name, a, b in zip(LEAVES, got, want, strict=True):
            assert a.shape == b.shape, name
            # Without specular and the debug channels, roughness and metalness
            # reach no channel; under fix_sky the sky SH none.
            unused = (name == "sky_sh" and fix_sky) or (
                name in ("roughness", "metalness") and not specular and channels < 21)
            if unused:
                assert not a.any() and not b.any(), name
                continue
            assert rel_err(a, b) < tol, (name, dtype, rel_err(a, b))


def _compute_colors_before(params, state, envlight_base, sky_sh, envlight_sh_degree,
                           sky_sh_degree, campos, specular=True, fix_sky=False, debug=True,
                           rgb_only=True):
    """`renderer.compute_colors` as it was before the shading operation."""
    xyz = G.get_xyz(params, state)
    albedo = G.get_albedo(params)
    kr = G.get_roughness(params)
    km = G.get_metalness(params)
    is_sky = state.is_sky[:, None]
    dir_pp_n = L.safe_normalize(xyz - campos[None, :])
    normal = G.get_normal(params, dir_pp_n)
    shaded = L.shade(envlight_base, envlight_sh_degree, xyz, normal, albedo, campos, kr, km,
                     specular=specular)
    if fix_sky:
        sky_rgb = torch.ones_like(xyz)
    else:
        sky_rgb = torch.clamp_min(eval_sh(sky_sh_degree, sky_sh.transpose(-1, -2), dir_pp_n)
                                  + 0.5, 0.0)
    rgb = torch.where(is_sky, sky_rgb, shaded.rgb)
    if rgb_only:
        return rgb, normal
    channels = [rgb, torch.where(is_sky, 0.0, shaded.diffuse),
                torch.where(is_sky, 0.0, shaded.specular), torch.zeros_like(xyz[:, :1]),
                0.5 * normal + 0.5]
    if debug:
        channels += [torch.where(is_sky, sky_rgb, 0.0), torch.where(is_sky, 0.0, kr),
                     torch.where(is_sky, 0.0, km),
                     torch.where(is_sky, torch.ones_like(albedo), albedo)]
    return torch.cat(channels, dim=-1), normal


def _scene(n=400):
    xyz, rot, scl, alb, rough, met, is_sky = random_rows(n, seed=5)
    g = torch.Generator().manual_seed(6)
    params = G.GaussianParams(xyz=xyz, albedo=alb, opacity=torch.zeros(n, 1), scaling=scl,
                              rotation=rot, roughness=rough, metalness=met,
                              sky_angles=torch.rand(n, 2, generator=g) * 1.5,
                              sky_radius=torch.tensor(80.0))
    state = G.GaussianState(alive=torch.ones(n, dtype=torch.bool), is_sky=is_sky,
                            sky_center=torch.tensor([0.5, 1.0, -2.0]),
                            max_radii2d=torch.zeros(n), xyz_grad_accum=torch.zeros(n),
                            denom=torch.zeros(n))
    return params, state


@pytest.mark.parametrize("rgb_only, debug, depth", [(True, True, False), (False, False, False),
                                                    (False, False, True), (False, True, False),
                                                    (False, True, True)])
def test_compute_colors_on_the_cpu_is_unchanged(rgb_only, debug, depth):
    """Values bit for bit as before; gradients of every leaf the shading reaches
    (xyz and the sky angles through get_xyz, rotation, albedo, roughness,
    metalness, the envlight, the sky SH) to float32 rounding. With `depth`,
    channel 9 is render_inputs' view depth, as its `torch.cat` wrote it."""
    params, state = _scene()
    base, sky = lighting(4, 1, seed=2)
    campos = torch.tensor(CAMPOS)
    view = torch.tensor(VIEW_ROW)

    def run(fn, **kw):
        p = params._replace(**{k: getattr(params, k).clone().requires_grad_(True) for k in
                               ("xyz", "rotation", "albedo", "roughness", "metalness",
                                "sky_angles")})
        b, s = base.clone().requires_grad_(True), sky.clone().requires_grad_(True)
        colors, normal = fn(p, state, b, s, 4, 1, campos, True, False, debug, rgb_only, **kw)
        if depth and fn is _compute_colors_before:
            x = G.get_xyz(p, state)
            d = x[:, 0] * view[0] + x[:, 1] * view[1] + x[:, 2] * view[2] + view[3]
            colors = torch.cat([colors[:, :9], d[:, None], colors[:, 10:]], dim=-1)
        g = torch.Generator().manual_seed(9)
        loss = (colors * torch.randn(colors.shape, generator=g)).sum()
        if normal is not None:
            loss = loss + (normal * torch.randn(normal.shape, generator=g)).sum()
        leaves = [p.xyz, p.sky_angles, p.rotation, p.albedo, p.roughness, p.metalness, b, s]
        return colors, normal, torch.autograd.grad(loss, leaves)

    c0, n0, g0 = run(_compute_colors_before)
    c1, n1, g1 = run(renderer.compute_colors, **({"view_row": view} if depth else {}))
    assert torch.equal(c1, c0) and torch.equal(n1, n0)
    for a, b in zip(g1, g0, strict=True):
        assert rel_err(a, b) < F32_TOL


def test_normals_only_where_asked_for():
    params, state = _scene(64)
    base, sky = lighting(4, 1, seed=2)
    colors, normal = renderer.compute_colors(params, state, base, sky, 4, 1,
                                             torch.tensor(CAMPOS), normals=False)
    assert normal is None and colors.shape == (64, 3)


def test_shading_rejects_what_no_kernel_takes():
    params, state = _scene(16)
    campos = torch.tensor(CAMPOS)
    base, sky = lighting(4, 1, seed=2)
    with pytest.raises(ValueError, match="the envlight must be"):
        renderer.compute_colors(params, state, base[:9], sky, 4, 1, campos)
    with pytest.raises(ValueError, match="camera position"):
        renderer.compute_colors(params, state, base, sky, 4, 1, campos.requires_grad_(True))
    rows = (torch.zeros(4, 3), torch.zeros(4, 4), torch.zeros(4, 3), torch.zeros(4, 3),
            torch.zeros(4, 1), torch.zeros(4, 1), torch.zeros(4, dtype=torch.bool))
    lut = torch.zeros(256, 256, 8)
    b6, s1 = lighting(6, 1, seed=1)
    with pytest.raises(ValueError, match="SH degrees"):
        shade_kernel.shade_forward(rows, b6, s1.reshape(-1, 3), torch.zeros(3), None, lut, 6, 1,
                                   3, True, False, False)
    with pytest.raises(ValueError, match="layouts"):
        shade_kernel.shade_forward(rows, base, sky.reshape(-1, 3), torch.zeros(3), None, lut, 4,
                                   1, 9, True, False, False)
    with pytest.raises(ValueError, match="envlight"):
        shade_kernel.shade_forward(rows, base[:9], sky.reshape(-1, 3), torch.zeros(3), None,
                                   lut, 4, 1, 3, True, False, False)
    with pytest.raises(ValueError, match="on the card only"):
        shade_kernel.shade_forward(rows, base, sky.reshape(-1, 3), torch.zeros(3), None, lut, 4,
                                   1, 3, True, False, False)
