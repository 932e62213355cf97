"""Legacy cubemap split-sum environment light: port of the JAX package's
`models/light_cubemap.py`.

The reference's original NVDIFFREC path (scene/NVDIFFREC/light_original.py:
`cubemap_mip`, `build_mips`, `shade`, hdr load) and its CUDA helpers
(`diffuse_cubemap`, `specular_cubemap`, renderutils/c_src/cubemap.cu). The main
relightable pipeline uses the SH light (models/light.py); this module covers the
legacy path: a 6-face cubemap whose mip chain is GGX-prefiltered for the
split-sum approximation. Plain PyTorch, as the JAX package's is plain jnp.

As in the JAX package, each mip level is prefiltered by GGX-importance Monte
Carlo and cube sampling is per-face bilinear (all six faces sampled, then the
direction's face selected; no seam blending). The Monte Carlo draws `u` can be
given; by default they come from a CPU `torch.Generator` seeded with `seed`
(one per mip level in `build_mips`, seed = level), so a seed gives the same
draws on every device. The samples are summed a chunk at a time instead of
one by one, which changes the float32 sums in their last bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.texture import bilinear_sample
from ..utils.hdr import read_hdr
from .brdf_lut import get_fg_lut
from .light import reflect, safe_normalize

LIGHT_MIN_RES = 16
MIN_ROUGHNESS = 0.08
MAX_ROUGHNESS = 0.5
CHUNK_DIRS = 1 << 20   # directions per chunk of Monte Carlo samples


def cube_to_dir(face: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Face uv in [-1, 1] -> direction (OpenGL cubemap convention, util.cube_to_dir)."""
    one = torch.ones_like(x)
    v = {0: (one, -y, -x), 1: (-one, -y, x), 2: (x, one, y), 3: (x, -one, -y),
         4: (x, -y, one)}.get(face, (-x, -y, -one))
    return torch.stack(v, dim=-1)


def dir_to_cube(d: torch.Tensor):
    """Direction -> (face index, u, v in [0, 1]): the dominant axis picks the
    face (x before y before z on ties)."""
    ax, ay, az = torch.abs(d[..., 0]), torch.abs(d[..., 1]), torch.abs(d[..., 2])
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    fx = torch.where(x > 0, 0, 1)
    fy = torch.where(y > 0, 2, 3)
    fz = torch.where(z > 0, 4, 5)
    face = torch.where((ax >= ay) & (ax >= az), fx, torch.where(ay >= az, fy, fz))
    ma = torch.maximum(torch.maximum(ax, ay), az) + 1e-12
    pick = lambda *c: torch.gather(torch.stack(c, dim=-1), -1, face[..., None])[..., 0]
    u = pick(-z / ma, z / ma, x / ma, x / ma, x / ma, -x / ma)
    v = pick(-y / ma, -y / ma, z / ma, -z / ma, -y / ma, -y / ma)
    return face, (u + 1) * 0.5, (v + 1) * 0.5


def sample_cubemap(cubemap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """cubemap: [6, R, R, C]; dirs: [..., 3] -> [..., C] (per-face bilinear)."""
    face, u, v = dir_to_cube(safe_normalize(dirs))
    uv = torch.stack([u, v], dim=-1)
    samples = torch.stack([bilinear_sample(cubemap[f], uv) for f in range(6)], dim=0)
    idx = face[None, ..., None].expand((1,) + face.shape + (samples.shape[-1],))
    return torch.gather(samples, 0, idx)[0]


def cubemap_mip(cubemap: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool one mip level (light_original.py:22-38 forward)."""
    six, r, _, c = cubemap.shape
    return cubemap.reshape(six, r // 2, 2, r // 2, 2, c).mean(dim=(2, 4))


def _face_dirs(res: int, device) -> torch.Tensor:
    g = (torch.arange(res, device=device) + 0.5) / res * 2.0 - 1.0
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    return torch.stack([safe_normalize(cube_to_dir(f, gx, gy)) for f in range(6)], dim=0)


def _draws(u, n_samples: int, seed: int, device) -> torch.Tensor:
    """The [n_samples, 2] uniform draws on `device`: `u` as given, else from a
    CPU generator seeded with `seed` (the same draws for every device)."""
    if u is None:
        u = torch.rand((n_samples, 2), generator=torch.Generator().manual_seed(seed))
    return torch.as_tensor(u if torch.is_tensor(u) else np.array(u, np.float32), device=device)


def _tangent_frame(n: torch.Tensor):
    up = torch.where(torch.abs(n[:, 2:3]) < 0.999, n.new_tensor([0.0, 0.0, 1.0]),
                     n.new_tensor([1.0, 0.0, 0.0]))
    t = safe_normalize(torch.linalg.cross(up, n, dim=-1))
    return t, torch.linalg.cross(n, t, dim=-1)


def _chunks(n_samples: int, n_dirs: int):
    step = max(1, min(n_samples, CHUNK_DIRS // max(n_dirs, 1)))
    return ((s, min(s + step, n_samples)) for s in range(0, n_samples, step))


def diffuse_cubemap(cubemap: torch.Tensor, n_samples: int = 4096, seed: int = 0,
                    u=None) -> torch.Tensor:
    """Cosine-convolved irradiance cubemap (ru.diffuse_cubemap equivalent):
    E(n) = mean over cosine-weighted directions of L(w). `u`: optional
    [n_samples, 2] uniform draws."""
    six, res, _, c = cubemap.shape
    dev = cubemap.device
    u = _draws(u, n_samples, seed, dev)
    r = torch.sqrt(u[:, 0])
    phi = 2 * math.pi * u[:, 1]
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                         torch.sqrt(torch.clamp_min(1 - u[:, 0], 0.0))], dim=-1)
    n = _face_dirs(res, dev).reshape(-1, 3)
    t, b = _tangent_frame(n)
    acc = torch.zeros((n.shape[0], c), device=dev)
    for s, e in _chunks(n_samples, n.shape[0]):
        lc = local[s:e, None, :]
        w = lc[..., 0:1] * t + lc[..., 1:2] * b + lc[..., 2:3] * n
        acc = acc + sample_cubemap(cubemap, w).sum(dim=0)
    return (acc / n_samples).reshape(six, res, res, c)


def specular_cubemap(cubemap: torch.Tensor, roughness: float, n_samples: int = 1024,
                     seed: int = 0, u=None) -> torch.Tensor:
    """GGX-prefiltered cubemap at one roughness (ru.specular_cubemap equivalent,
    Karis split-sum prefilter with N = V = R). `u`: optional [n_samples, 2]
    uniform draws."""
    six, res, _, c = cubemap.shape
    if roughness <= MIN_ROUGHNESS * 0.5:
        return cubemap
    dev = cubemap.device
    a = roughness * roughness
    u = _draws(u, n_samples, seed, dev)
    phi = 2 * math.pi * u[:, 0]
    ct = torch.sqrt((1 - u[:, 1]) / (1 + (a * a - 1) * u[:, 1]))
    st = torch.sqrt(torch.clamp_min(1 - ct ** 2, 0.0))
    local_h = torch.stack([torch.cos(phi) * st, torch.sin(phi) * st, ct], dim=-1)
    n = _face_dirs(res, dev).reshape(-1, 3)
    t, b = _tangent_frame(n)
    acc = torch.zeros((n.shape[0], c), device=dev)
    wsum = torch.zeros((n.shape[0], 1), device=dev)
    for s, e in _chunks(n_samples, n.shape[0]):
        lh = local_h[s:e, None, :]
        h = lh[..., 0:1] * t + lh[..., 1:2] * b + lh[..., 2:3] * n
        l = reflect(n.expand_as(h), h)
        w = torch.clamp_min(torch.sum(n * l, dim=-1, keepdim=True), 0.0)
        acc = acc + (sample_cubemap(cubemap, l) * w).sum(dim=0)
        wsum = wsum + w.sum(dim=0)
    return (acc / torch.clamp_min(wsum, 1e-6)).reshape(six, res, res, c)


class CubemapLightMips(NamedTuple):
    specular: tuple          # tuple of [6, R_i, R_i, 3] prefiltered mips
    diffuse: torch.Tensor    # [6, R_min, R_min, 3]


def build_mips(base: torch.Tensor, cutoff: float = 0.99, diffuse_u=None,
               specular_u=None) -> CubemapLightMips:
    """Mip chain + GGX prefilter + diffuse convolution (light_original.py:70-81).
    Level i's specular draws come from seed i, the diffuse draws from seed 0;
    `diffuse_u` / `specular_u` (one [1024, 2] array per level) replace them."""
    chain = [base]
    while chain[-1].shape[1] > LIGHT_MIN_RES:
        chain.append(cubemap_mip(chain[-1]))
    diffuse = diffuse_cubemap(chain[-1], u=diffuse_u)
    spec = []
    n_lvl = len(chain)
    for idx, level in enumerate(chain):
        if idx < n_lvl - 1:
            rough = (idx / max(n_lvl - 2, 1)) * (MAX_ROUGHNESS - MIN_ROUGHNESS) + MIN_ROUGHNESS
        else:
            rough = 1.0
        spec.append(specular_cubemap(level, rough, seed=idx,
                                     u=None if specular_u is None else specular_u[idx]))
    return CubemapLightMips(specular=tuple(spec), diffuse=diffuse)


def get_mip(roughness: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Roughness -> fractional mip level (light_original.py:65-68)."""
    lo = (torch.clamp(roughness, MIN_ROUGHNESS, MAX_ROUGHNESS) - MIN_ROUGHNESS) / (
        MAX_ROUGHNESS - MIN_ROUGHNESS) * (n_levels - 2)
    hi = (torch.clamp(roughness, MAX_ROUGHNESS, 1.0) - MAX_ROUGHNESS) / (
        1.0 - MAX_ROUGHNESS) + n_levels - 2
    return torch.where(roughness < MAX_ROUGHNESS, lo, hi)


def shade_cubemap(mips: CubemapLightMips, positions, normals, kd, ks, view_pos,
                  specular: bool = True, fg_lut=None):
    """Split-sum shading against the prefiltered cubemap
    (light_original.py:129-186). ks = (spec_strength_unused, roughness, metallic);
    `fg_lut` defaults to the [256, 256, 2] split-sum LUT."""
    wo = safe_normalize(view_pos[None, :] - positions)
    if specular:
        roughness = ks[..., 1:2]
        metallic = ks[..., 2:3]
        spec_col = (1.0 - metallic) * 0.04 + kd * metallic
        diff_col = kd * (1.0 - metallic)
    else:
        diff_col = kd

    irradiance = sample_cubemap(mips.diffuse, normals)
    shaded = diff_col * irradiance
    if not specular:
        return shaded

    reflvec = safe_normalize(reflect(wo, normals))
    lut = torch.as_tensor(get_fg_lut() if fg_lut is None else fg_lut, device=positions.device)
    ndotv = torch.clamp_min(torch.sum(wo * normals, dim=-1, keepdim=True), 1e-4)
    fg = bilinear_sample(lut, torch.cat([ndotv, roughness], dim=-1))

    n_lvl = len(mips.specular)
    miplevel = get_mip(roughness, n_lvl)
    lo = torch.clamp(torch.floor(miplevel).long(), 0, n_lvl - 1)
    frac = miplevel - lo.to(miplevel.dtype)
    samples = torch.stack([sample_cubemap(m, reflvec) for m in mips.specular], dim=0)
    hi = torch.clamp(lo + 1, 0, n_lvl - 1)
    s_lo = torch.gather(samples, 0, lo.expand(-1, 3)[None])[0]
    s_hi = torch.gather(samples, 0, hi.expand(-1, 3)[None])[0]
    spec = s_lo * (1 - frac) + s_hi * frac

    reflectance = spec_col * fg[..., 0:1] + fg[..., 1:2]
    return shaded + spec * reflectance


def load_hdr_cubemap(path: str, res: int = 512, device="cuda") -> torch.Tensor:
    """A lat-long image -> [6, res, res, 3] cubemap (light_original.py:193-206)
    on `device` (the card unless the caller asks for the CPU). Radiance .hdr is
    read by `utils/hdr.read_hdr` (OpenCV's decode, bitwise), 8-bit images by
    PIL (/ 255); OpenEXR needs OpenCV, which this package does not use."""
    device = resolve_device(device)
    lower = path.lower()
    if lower.endswith(".exr"):
        raise ValueError(f"{path}: OpenEXR images need OpenCV (cv2), which this package "
                         "does not use; convert the envmap to Radiance .hdr")
    if lower.endswith(".hdr"):
        img = read_hdr(path)
    else:
        from PIL import Image

        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"), np.float64) / 255.0
    img = torch.as_tensor(np.ascontiguousarray(img, np.float32), device=device)
    dirs = _face_dirs(res, device)   # [6, R, R, 3]
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    theta = torch.arccos(torch.clamp(-y, -1, 1))
    phi = torch.remainder(torch.atan2(x, z), 2 * math.pi)
    uv = torch.stack([phi / (2 * math.pi), theta / math.pi], dim=-1)
    return bilinear_sample(img, uv)
