"""Point-light PBR BSDF op library: port of the JAX package's `ops/bsdf.py`.

The reference's NVDIFFREC renderutils op set (renderutils/bsdf.py python twins
and c_src/bsdf.cu: prepare_shading_normal, lambert, frostbite, phong,
fresnel_shlick, ndf_ggx, lambda_ggx, masking_smith, pbr_specular, pbr_bsdf),
its image losses (loss.py) and point / vector transforms (mesh.cu). Plain
PyTorch, as the JAX package's are plain jnp: autograd gives the backward the
reference writes by hand. No TPU kernel computed them, so none is ported here.

Vectors are normalized with rsqrt, as in the JAX package. CUDA's rsqrtf is not
correctly rounded, and GGX's peak amplifies a 1-ulp change of the half vector:
with roughness down to the 0.08 clamp, the card and the CPU differ by up to
~6e-4 of the largest value at a million random points (two normalization
formulas on the CPU by ~2e-4); with roughness in [0.5, 1], by under 1e-5.
"""

from __future__ import annotations

import math

import torch

from ..utils.graphics import safe_normalize

NORMAL_THRESHOLD = 0.1
SPECULAR_EPSILON = 1e-4


def _dot(x, y):
    return torch.sum(x * y, dim=-1, keepdim=True)


def reflect(x, n):
    return 2 * _dot(x, n) * n - x


def _bend_normal(view_vec, smooth_nrm, geom_nrm, two_sided_shading: bool):
    if two_sided_shading:
        facing = _dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(facing, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(facing, geom_nrm, -geom_nrm)
    t = torch.clamp(_dot(view_vec, smooth_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + t * (smooth_nrm - geom_nrm)


def _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl: bool):
    smooth_bitang = safe_normalize(torch.linalg.cross(smooth_tng, smooth_nrm, dim=-1))
    bit_sign = -1.0 if opengl else 1.0
    shading_nrm = (
        smooth_tng * perturbed_nrm[..., 0:1]
        + bit_sign * smooth_bitang * perturbed_nrm[..., 1:2]
        + smooth_nrm * torch.clamp_min(perturbed_nrm[..., 2:3], 0.0)
    )
    return safe_normalize(shading_nrm)


def prepare_shading_normal(pos, view_pos, perturbed_nrm, smooth_nrm, smooth_tng,
                           geom_nrm, two_sided_shading: bool = True,
                           opengl: bool = True):
    """Tangent-space normal perturbation + two-sided bending
    (bsdf.py:28-51, c_src/normal.cu)."""
    smooth_nrm = safe_normalize(smooth_nrm)
    smooth_tng = safe_normalize(smooth_tng)
    view_vec = safe_normalize(view_pos - pos)
    shading_nrm = _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl)
    return _bend_normal(view_vec, shading_nrm, geom_nrm, two_sided_shading)


def lambert(nrm, wi):
    """(bsdf.py:57-58)"""
    return torch.clamp_min(_dot(nrm, wi), 0.0) / math.pi


def fresnel_shlick(f0, f90, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    return f0 + (f90 - f0) * (1.0 - c) ** 5.0


def frostbite(nrm, wi, wo, linear_roughness):
    """Frostbite diffuse (bsdf.py:64-81)."""
    wi_dot_n = _dot(wi, nrm)
    wo_dot_n = _dot(wo, nrm)
    h = safe_normalize(wo + wi)
    wi_dot_h = _dot(wi, h)
    energy_bias = 0.5 * linear_roughness
    energy_factor = 1.0 - (0.51 / 1.51) * linear_roughness
    f90 = energy_bias + 2.0 * wi_dot_h * wi_dot_h * linear_roughness
    res = fresnel_shlick(1.0, f90, wi_dot_n) * fresnel_shlick(1.0, f90, wo_dot_n) * energy_factor
    return torch.where((wi_dot_n > 0.0) & (wo_dot_n > 0.0), res, 0.0)


def phong(nrm, wo, wi, N):
    """(bsdf.py:85-88)"""
    dp_r = torch.clamp(_dot(reflect(wo, nrm), wi), 0.0, 1.0)
    dp_l = torch.clamp(_dot(nrm, wi), 0.0, 1.0)
    return (dp_r ** N) * dp_l * (N + 2) / (2 * math.pi)


def ndf_ggx(alpha_sqr, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    d = (c * alpha_sqr - c) * c + 1
    return alpha_sqr / (d * d * math.pi)


def lambda_ggx(alpha_sqr, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    cos_sqr = c * c
    tan_sqr = (1.0 - cos_sqr) / cos_sqr
    return 0.5 * (torch.sqrt(1 + alpha_sqr * tan_sqr) - 1.0)


def masking_smith(alpha_sqr, cos_theta_i, cos_theta_o):
    """Height-correlated Smith (bsdf.py:112-115)."""
    return 1.0 / (1.0 + lambda_ggx(alpha_sqr, cos_theta_i) + lambda_ggx(alpha_sqr, cos_theta_o))


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness: float = 0.08):
    """Cook-Torrance GGX specular (bsdf.py:117-134)."""
    a = torch.clamp(alpha, min_roughness * min_roughness, 1.0)
    alpha_sqr = a * a
    h = safe_normalize(wo + wi)
    wo_dot_n = _dot(wo, nrm)
    wi_dot_n = _dot(wi, nrm)
    wo_dot_h = _dot(wo, h)
    n_dot_h = _dot(nrm, h)
    D = ndf_ggx(alpha_sqr, n_dot_h)
    G = masking_smith(alpha_sqr, wo_dot_n, wi_dot_n)
    F = fresnel_shlick(col, 1.0, wo_dot_h)
    w = F * D * G * 0.25 / torch.clamp_min(wo_dot_n, SPECULAR_EPSILON)
    frontfacing = (wo_dot_n > SPECULAR_EPSILON) & (wi_dot_n > SPECULAR_EPSILON)
    return torch.where(frontfacing, w, 0.0)


def pbr_bsdf(kd, arm, pos, nrm, view_pos, light_pos, min_roughness: float = 0.08,
             bsdf: int = 0):
    """Full point-light PBR: kd / arm textures, Lambert (bsdf=0) or Frostbite
    diffuse (bsdf.py:136-151)."""
    wo = safe_normalize(view_pos - pos)
    wi = safe_normalize(light_pos - pos)
    spec_str = arm[..., 0:1]
    roughness = arm[..., 1:2]
    metallic = arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1 - spec_str)
    kd_eff = kd * (1.0 - metallic)
    if bsdf == 0:
        diffuse = kd_eff * lambert(nrm, wi)
    else:
        diffuse = kd_eff * frostbite(nrm, wi, wo, roughness)
    specular = pbr_specular(ks, nrm, wo, wi, roughness * roughness, min_roughness=min_roughness)
    return diffuse + specular


def _tonemap_srgb(f):
    return torch.where(f > 0.0031308,
                       torch.pow(torch.clamp_min(f, 0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
                       12.92 * f)


def image_loss(img, target, loss: str = "l1", tonemapper: str = "none"):
    """SMAPE / MSE / L1 / RELMSE with an optional log-sRGB tonemap
    (renderutils loss twins)."""
    if tonemapper == "log_srgb":
        img = _tonemap_srgb(torch.log(torch.clamp(img, 0.0, 65535.0) + 1))
        target = _tonemap_srgb(torch.log(torch.clamp(target, 0.0, 65535.0) + 1))
    err = img - target
    if loss == "mse":
        return torch.mean(err ** 2)
    if loss == "smape":
        return torch.mean(torch.abs(err) / (torch.abs(img) + torch.abs(target) + 0.01))
    if loss == "relmse":
        return torch.mean(err ** 2 / (target ** 2 + 0.1))
    return torch.mean(torch.abs(err))


def xfm_points(points, matrix):
    """Homogeneous point transform (renderutils mesh.cu twin). points: [..., 3],
    matrix: [4, 4] in the math convention."""
    return points @ matrix[:3, :3].T + matrix[:3, 3]


def xfm_vectors(vectors, matrix):
    return vectors @ matrix[:3, :3].T
