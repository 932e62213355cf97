"""Rows for the shading tests (`ops/shading.py`, `csrc/shade.cu`): random pool
rows, and rows at the chain's edges. Torch only, so the card tests can use it.
"""

import math

import torch

CAMPOS = (0.1, -0.2, 0.3)


def edge_rows():
    """(xyz, rotation, scaling, albedo, roughness, metalness, is_sky) rows, raw
    leaves, placed against CAMPOS:
    - n.v at its floor: the smallest axis (x, identity rotation) is normal to
      the view ray, so n.v = 0 (and the flip test reads -0 >= 0), the LUT's u
      at its left border;
    - n.v = 1: the smallest axis (z) along the ray, the LUT's u at its right
      border (the clamped neighbour);
    - roughness at 0.08 (bsdf.py's clamp), near 0 (the LUT's v at its top
      border) and near 1 (its bottom border);
    - equal scales (the first minimum wins);
    - a padded pool row: every leaf 0;
    - sky rows, one with a zero quaternion."""
    c = CAMPOS
    ray = [c[0], c[1], c[2] + 4.0]
    ident = [1.0, 0.0, 0.0, 0.0]
    logit = lambda p: math.log(p / (1 - p))
    rows = [
        (ray, ident, [-3.0, -1.0, -1.0], [0.2, -0.3, 0.5], 0.4, -0.5, False),
        (ray, ident, [-1.0, -1.0, -3.0], [0.2, -0.3, 0.5], -1.0, 1.0, False),
        (ray, [0.9, 0.1, -0.3, 0.2], [-1.0, -3.0, -2.0], [1.0, 0.0, -1.0], logit(0.08), 0.0,
         False),
        ([0.5, 0.3, 5.0], [0.3, 0.8, 0.1, -0.4], [-2.0, -2.5, -1.0], [0.0, 0.5, 1.0], -20.0,
         2.0, False),
        ([-0.7, 0.2, 3.0], [0.5, -0.5, 0.5, 0.5], [-1.5, -2.0, -2.2], [-2.0, 0.3, 0.1], 20.0,
         -2.0, False),
        ([0.3, -0.4, 4.5], [0.7, 0.1, 0.2, -0.6], [-2.0, -2.0, -2.0], [0.4, 0.4, 0.4], 0.0, 0.0,
         False),
        ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 0.0, 0.0,
         False),
        ([30.0, -40.0, 60.0], [0.2, 0.4, -0.1, 0.9], [-1.0, -2.0, -1.5], [0.1, 0.2, 0.3], 0.5,
         0.5, True),
        ([-50.0, -10.0, 40.0], [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 0.0, 0.0,
         True),
    ]
    cols = list(zip(*rows))
    f = lambda v, shape: torch.tensor(v, dtype=torch.float32).reshape(shape)
    n = len(rows)
    return (f(cols[0], (n, 3)), f(cols[1], (n, 4)), f(cols[2], (n, 3)), f(cols[3], (n, 3)),
            f(cols[4], (n, 1)), f(cols[5], (n, 1)), torch.tensor(cols[6], dtype=torch.bool))


def random_rows(n: int, seed: int, sky_share: float = 0.2):
    """n random rows of raw leaves in front of CAMPOS, with the edge rows first."""
    g = torch.Generator().manual_seed(seed)
    k = n - len(edge_rows()[0])
    rnd = (
        torch.randn(k, 3, generator=g) * 2 + torch.tensor([CAMPOS[0], CAMPOS[1], CAMPOS[2] + 4]),
        torch.randn(k, 4, generator=g),
        torch.randn(k, 3, generator=g) * 0.5 - 3,
        torch.randn(k, 3, generator=g),
        torch.randn(k, 1, generator=g) * 2,
        torch.randn(k, 1, generator=g) * 2,
        torch.rand(k, generator=g) < sky_share,
    )
    return tuple(torch.cat([e, r]) for e, r in zip(edge_rows(), rnd))


def lighting(env_deg: int, sky_deg: int, seed: int):
    """(envlight [(env_deg+1)**2, 3], sky SH [1, (sky_deg+1)**2, 3]): an
    envlight bright enough that most rows clear the irradiance floor, and
    some do not."""
    g = torch.Generator().manual_seed(seed)
    base = torch.randn((env_deg + 1) ** 2, 3, generator=g) * 0.5
    base[0] += 1.5
    sky = torch.randn(1, (sky_deg + 1) ** 2, 3, generator=g) * 0.3
    return base, sky


VIEW_ROW = (0.1, 0.2, 0.9, 0.5)


def rel_err(got, want):
    """max |got - want| / max |want|."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
