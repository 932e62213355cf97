"""SH environment light with Cook-Torrance split-sum shading: port of the JAX
package's `models/light.py` (`safe_normalize`, `reflect`, `diffuse_irradiance`,
`specular_light_sh`, `sample_illumination`, `shade`). Stateless: the SH coefficients (`base`, [(deg+1)**2, 3]) come from the
illumination MLP per image.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops.texture import bilinear_sample_packed
from ..utils.sh import eval_sh, gauss_kernel, gamma_correction, sh_basis
from .brdf_lut import get_fg_lut_quad

# The specular [N, K] @ [K, 3] product below feeds rendered colors: it must run
# in full float32 on the card, as the JAX package pins it to HIGHEST. TF32
# keeps about three decimal digits, so it is switched off here explicitly.
torch.backends.cuda.matmul.allow_tf32 = False

# Ramamoorthi-Hanrahan irradiance constants.
C1 = 0.429043
C2 = 0.511664
C3 = 0.743125
C4 = 0.886227
C5 = 0.247708


class ShadeOutput(NamedTuple):
    rgb: torch.Tensor       # [N, 3] gamma-corrected shaded color
    diffuse: torch.Tensor   # [N, 3] gamma-corrected diffuse component
    specular: torch.Tensor  # [N, 3] gamma-corrected specular component


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """NVDIFFREC's safe_normalize: clamp |x|^2 before sqrt."""
    return x / torch.sqrt(torch.clamp_min(torch.sum(x * x, dim=-1, keepdim=True), eps))


def reflect(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return 2 * torch.sum(x * n, dim=-1, keepdim=True) * n - x


def diffuse_irradiance(base: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Degree-2 analytic irradiance. base: [>=9, 3]; normal: [N, 3] -> [N, 3]."""
    x, y, z = normal[..., 0, None], normal[..., 1, None], normal[..., 2, None]
    return (
        C1 * base[8] * (x**2 - y**2)
        + C3 * base[6] * z**2
        + C4 * base[0]
        - C5 * base[6]
        + 2 * C1 * base[4] * x * y
        + 2 * C1 * base[7] * x * z
        + 2 * C1 * base[5] * y * z
        + 2 * C2 * base[3] * x
        + 2 * C2 * base[1] * y
        + 2 * C2 * base[2] * z
    )


def specular_light_sh(base: torch.Tensor, kr: torch.Tensor, sh_degree: int) -> torch.Tensor:
    """The environment SH convolved per band with the Gauss-Weierstrass kernel
    of each roughness. base: [(deg+1)**2, 3]; kr: [N, 1] -> [N, (deg+1)**2, 3]."""
    return gauss_kernel(kr, sh_degree)[..., None] * base[None]


def sample_illumination(base: torch.Tensor, sh_degree: int, positions: torch.Tensor,
                        view_pos: torch.Tensor) -> torch.Tensor:
    """Sky radiance along the view rays to positions [N, 3]: the environment SH
    at each ray's direction, clamped at 0, gamma-corrected -> [N, 3]."""
    d = safe_normalize(positions - view_pos)
    illu = torch.clamp_min(eval_sh(sh_degree, base.transpose(0, 1)[None], d), 0.0)
    return gamma_correction(illu)


@functools.lru_cache(maxsize=None)
def _fg_lut_quad_on(device: torch.device) -> torch.Tensor:
    """The quad-packed LUT, copied to each device once."""
    return torch.as_tensor(get_fg_lut_quad(), device=device)


def shade(base: torch.Tensor, sh_degree: int, positions: torch.Tensor,
          normals: torch.Tensor, albedo: torch.Tensor, view_pos: torch.Tensor,
          kr: torch.Tensor, km: torch.Tensor | None = None,
          specular: bool = True) -> ShadeOutput:
    """Cook-Torrance IBL shading per Gaussian.

    Args:
        base: [(deg+1)**2, 3] environment SH.
        positions: [N, 3] world positions.
        normals: [N, 3] (view-flipped minimum-axis normals).
        albedo: [N, 3] in (0, 1).
        view_pos: [3] camera position.
        kr: [N, 1] roughness; km: [N, 1] metalness.
        specular: Lambertian-only if False.
    """
    irr = torch.clamp_min(diffuse_irradiance(base, normals), 1e-4)
    diffuse_hdr = albedo * irr
    diffuse_ldr = gamma_correction(diffuse_hdr)

    if not specular:
        zeros = torch.zeros_like(diffuse_ldr)
        return ShadeOutput(rgb=diffuse_ldr, diffuse=diffuse_ldr, specular=zeros)

    wo = safe_normalize(view_pos[None, :] - positions)
    reflvec = safe_normalize(reflect(wo, normals))
    ndotv = torch.clamp_min(torch.sum(wo * normals, dim=-1, keepdim=True), 1e-4)
    fg_uv = torch.cat([ndotv, kr], dim=-1)
    fg = bilinear_sample_packed(_fg_lut_quad_on(positions.device), fg_uv)  # [N, 2]

    # Per-band Gauss-Weierstrass attenuation folded into the basis row, then one
    # float32 [N, K] @ [K, 3] product against the shared environment SH.
    k = sh_basis(sh_degree, reflvec) * gauss_kernel(kr, sh_degree)
    spec_irr = torch.clamp_min(k @ base[: k.shape[-1]], 1e-4)

    if km is None:
        F0 = torch.full_like(albedo, 0.04)
    else:
        F0 = (1.0 - km) * 0.04 + albedo * km
    reflectivity = F0 * fg[..., 0:1] + fg[..., 1:2]
    specular_hdr = spec_irr * reflectivity

    shaded_hdr = diffuse_hdr + specular_hdr if km is None else (1 - km) * diffuse_hdr + specular_hdr
    return ShadeOutput(
        rgb=gamma_correction(shaded_hdr),
        diffuse=diffuse_ldr,
        specular=gamma_correction(specular_hdr),
    )
