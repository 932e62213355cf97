"""Rows and cameras for the preprocess tests (`ops/preprocess.py`,
`csrc/preprocess.cu`): random pool rows, and rows at the chain's edges. Torch
only, so the card tests can use it.
"""

import math

import torch

from relightable3dgaussians_w_torch import synthetic
from relightable3dgaussians_w_torch.utils.graphics import covariance_3d

TAN = 0.5      # tan(fov / 2) of the edge camera: focal = width, and an
               # on-axis row's Jacobian at z = 4 is width / 4, a power of two
SIZE = 64      # the edge camera's width and height


def edge_camera(device="cpu"):
    """A camera at the origin looking down +z with tan(fov / 2) = TAN."""
    return synthetic.camera(SIZE, SIZE, fov_deg=math.degrees(2 * math.atan(TAN)),
                            device=device)


def edge_rows():
    """(means3d [k, 3], scales [k, 3], quats [k, 4], opacities [k], active [k],
    cov3d_precomp [k, 6]) at the chain's edges, for the edge camera:
    - behind the near plane: z = 0.1, z = 0.2 exactly (t2 > 0.2 is false),
      behind the camera;
    - clamped at the frustum limits (x / z = 1.5 > 1.3 TAN), and a row at the
      limit exactly (x / z = 1.3 TAN: maximum's and minimum's ties);
    - a row culled by `active`, and a padded pool row (every leaf 0);
    - an opacity under 1/255, one at 1/255 exactly, one of 1;
    - a scale whose rect covers the grid, a scale of 1e-4;
    - with the precomputed covariance: a row whose screen covariance is
      singular (cxx = 0, det = 0: the conic's `det != 0` branch), the others
      their scales' and rotations' covariance.
    """
    lim = float(torch.tensor(1.3, dtype=torch.float32) * torch.tensor(TAN, dtype=torch.float32))
    q = [0.8, 0.3, -0.4, 0.33]
    rows = [  # means, scales, quat, opacity, active
        ([0.1, 0.2, 0.1], [0.05, 0.03, 0.02], q, 0.8, True),
        ([0.0, 0.0, 0.2], [0.05, 0.03, 0.02], q, 0.8, True),
        ([0.5, -0.3, -2.0], [0.05, 0.03, 0.02], q, 0.8, True),
        ([3.0, -2.5, 2.0], [0.2, 0.1, 0.05], q, 0.8, True),
        ([lim, -lim, 1.0], [0.02, 0.03, 0.01], q, 0.6, True),
        ([0.2, 0.1, 3.0], [0.05, 0.05, 0.05], q, 0.9, False),
        ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0], 0.0, False),
        ([-0.3, 0.4, 3.5], [0.05, 0.04, 0.03], q, 1e-3, True),
        ([0.3, 0.2, 3.5], [0.05, 0.04, 0.03], q, 1.0 / 255.0, True),
        ([0.1, -0.2, 2.5], [0.05, 0.04, 0.03], q, 1.0, True),
        ([0.0, 0.1, 3.0], [5.0, 5.0, 5.0], q, 0.7, True),
        ([0.4, -0.4, 3.0], [1e-4, 1e-4, 1e-4], q, 0.7, True),
        ([0.0, 0.0, 4.0], [0.05, 0.04, 0.03], q, 0.7, True),   # singular with cov3d_precomp
    ]
    cols = list(zip(*rows))
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    means, scales, quats, opac = f(cols[0]), f(cols[1]), f(cols[2]), f(cols[3])
    quats = quats / quats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    cov = covariance_3d(scales, quats)
    # At (0, 0, 4) the Jacobian's rows are (16, 0, 0) and (0, 16, 0): a world
    # xx of -0.3 / 256 gives cxx = -0.3 + 0.3 = 0 exactly.
    cov[-1] = 0.0
    cov[-1, 0] = torch.tensor(-0.3, dtype=torch.float32) / 256.0
    return means, scales, quats, opac, torch.tensor(cols[4]), cov


def random_rows(n: int, seed: int):
    """n random pool rows (the edge rows first) around (0, 0, 4.5): positions
    spread 1.5 (some behind the near plane, some outside the frustum),
    scales exp(N(-3.5, 0.6^2)), random rotations, opacities uniform in (0, 1),
    88% active; (means3d, scales, quats, opacities, active, cov3d_precomp)."""
    g = torch.Generator().manual_seed(seed)
    edge = edge_rows()
    k = n - edge[0].shape[0]
    means = torch.randn(k, 3, generator=g) * 1.5 + torch.tensor([0.0, 0.0, 4.5])
    scales = torch.exp(torch.randn(k, 3, generator=g) * 0.6 - 3.5)
    quats = torch.randn(k, 4, generator=g)
    quats = quats / quats.norm(dim=-1, keepdim=True)
    opac = torch.rand(k, generator=g)
    active = torch.rand(k, generator=g) < 0.88
    rnd = (means, scales, quats, opac, active, covariance_3d(scales, quats))
    return tuple(torch.cat([a, b]) for a, b in zip(edge, rnd))


def cotangents(pre, seed: int, idle_share: float = 0.3):
    """Random cotangents of a PreprocessOut's mean2d, conic, depth and cov3d,
    all 0 on a share of the rows (as the gather's transpose leaves a row with
    no entries); the rows with no tiles keep theirs, so that the derivation
    is held on the culled and clamped rows too. Returns them and the rows
    left all 0."""
    g = torch.Generator().manual_seed(seed)
    n = pre.mean2d.shape[0]
    idle = torch.rand(n, generator=g) < idle_share
    out = []
    for t in (pre.mean2d, pre.conic, pre.depth, pre.cov3d):
        c = torch.randn(t.shape, generator=g)
        c[idle] = 0.0
        out.append(c.to(t.device))
    return out, idle.to(pre.mean2d.device)
