"""Depth-ordered alpha compositing over 16x16 tiles: the plain PyTorch versions.

Port of the JAX package's `ops/composite.py` (`composite_forward`,
`composite_backward`). These are the plain versions of the hand-written CUDA
compositor kernels (`csrc/tile_composite.cu`, wrapped by
`ops/cuda/tile_composite.py`): the CPU path runs them, and the card compares the
kernels with them. They work over the flat sorted entry list addressed by
`tile_start` / `tile_end`, with no per-tile depth cap.

The per-pixel front-to-back loop is a cumulative product over each tile's
entries: with effective alphas a_g (zero where the reference `continue`s: power
> 0 or alpha < 1/255), P_g = prod_{j<=g}(1 - a_j), the termination
`T*(1-alpha) < 1e-4` is the prefix predicate P_g >= 1e-4, and the weights are
w_g = include_g * a_g * P_{g-1}.

The backward is closed-form: with S_g = sum_{j>g} w_j (c_j . gbar), the suffix
sum, and B = bg . gbar + gbar_Tfinal,
dL/da_g = P_{g-1} (c_g . gbar) - (S_g + T_final * B) / (1 - a_g); the gradient of
the saturation alpha = min(0.99, op * G) is not masked, as in the reference.
Each entry's gradient row is written to its own slot: no atomics.

The skip predicate power > 0 is a discontinuity of height ~opacity, so the
kernel and this version compute power with the same scalar op order:
`entry_quad_coeffs` then `power_separable`, every step an elementwise float32
product or sum (the kernel rounds each of them on its own: `__fmul_rn`,
`__fadd_rn`, `__fsub_rn`, no FMA).

Packed serving colors (`pack_rb`, `unpack_rb`, `composite_forward_packed`): R
and B are quantized to 12-bit fixed point and share one float32 column as
q_r * 4096 + q_b (an integer below 2^24, exact in float32); G stays exact. The
packed entry row is 8 floats: mean2d, conic, opacity, packed R|B, G. The
packed kernel B' unpacks each row with the float ops of `unpack_rb`, so it
composites what `composite_forward` composites on `unpack_rb(pack_rb(c))`.
"""

from __future__ import annotations

import numpy as np
import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_SAT = 0.99
T_EPS = 1e-4

PACK_LIM = 8.0         # packed R and B are clamped to [0, PACK_LIM]
PACK_LEVELS = 4095.0   # 12-bit levels
# The dequantization step: the float32 rounding of the double 8/4095, which is
# what the JAX package's weak-typed Python float becomes (not 8.0f / 4095.0f).
PACK_STEP = float(np.float32(PACK_LIM / PACK_LEVELS))


def pack_rb(colors: torch.Tensor):
    """[N, 3] rgb -> ([N] packed R|B, [N] exact G), in the JAX package's op
    order (`ops/pallas/tile_composite.py` `pack_rb`): clip to [0, 8], times
    4095 / 8 = 511.875, round half to even, q_r * 4096 + q_b."""
    q = torch.round(torch.clamp(colors[:, ::2], 0.0, PACK_LIM) * (PACK_LEVELS / PACK_LIM))
    return q[:, 0] * 4096.0 + q[:, 1], colors[:, 1]


def unpack_rb(rb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_rb`: [N] packed R|B and [N] G -> [N, 3] rgb. The floor
    and the remainder are exact on the packed integers."""
    q_r = torch.floor(rb * (1.0 / 4096.0))
    q_b = rb - q_r * 4096.0
    return torch.stack([q_r * PACK_STEP, g, q_b * PACK_STEP], dim=-1)


def entry_quad_coeffs(mxl, myl, ca, cb, cc):
    """Per-entry coefficients of power over tile-local pixel coords.

    power = -0.5*ca*(mxl-px)^2 - 0.5*cc*(myl-py)^2 - cb*(mxl-px)*(myl-py)
          = q0 + qx*px + qy*py + qxx*px^2 + qyy*py^2 + qxy*px*py.
    """
    q0 = -0.5 * (ca * (mxl * mxl) + cc * (myl * myl)) - cb * (mxl * myl)
    qx = ca * mxl + cb * myl
    qy = cc * myl + cb * mxl
    return q0, qx, qy, -0.5 * ca, -0.5 * cc, -cb


def power_separable(q, pv, pv2, pp, tile_f, rep_g):
    """power = f(px) + g(py) + qxy*px*py from 16-wide per-entry f / g tables.

    pv, pv2: pixel coordinates 0..tile-1 and their squares (exact integers);
    pp: px*py per full pixel. tile_f / rep_g expand the f / g tables to the
    P = tile^2 pixels (f by px = p % tile, g by py = p // tile): data movement
    only, so every layout gives the same values.
    """
    q0, qx, qy, qxx, qyy, qxy = q
    f = q0 + qx * pv + qxx * pv2
    g = qy * pv + qyy * pv2
    return (tile_f(f) + rep_g(g)) + qxy * pp


def _tile_batch(feat, starts, counts, tids, grid_x, tile, length):
    """alpha [B, L, P] of a batch of tiles (L = length) and a dict of what the
    backward needs: entry rows, slot indices, validity, G, skip."""
    D = feat.shape[0]
    dev = feat.device
    lane = torch.arange(length, device=dev)
    idx = starts[:, None] + lane[None, :]                          # [B, L]
    valid = lane[None, :] < counts[:, None]
    rows = feat[torch.clamp(idx, 0, max(D - 1, 0))]                # [B, L, F]
    tx0 = ((tids % grid_x) * tile).to(torch.float32)[:, None]      # [B, 1]
    ty0 = ((tids // grid_x) * tile).to(torch.float32)[:, None]
    q6 = entry_quad_coeffs(rows[..., 0] - tx0, rows[..., 1] - ty0,
                           rows[..., 2], rows[..., 3], rows[..., 4])  # [B, L] each
    q6 = tuple(q[..., None] for q in q6)                            # [B, L, 1]
    pv = torch.arange(tile, dtype=torch.float32, device=dev)        # [tile]
    pix = torch.arange(tile * tile, device=dev)
    pp = ((pix % tile) * (pix // tile)).to(torch.float32)           # [P] exact ints
    power = power_separable(
        q6, pv, pv * pv, pp,
        tile_f=lambda f: f.repeat(1, 1, tile),                      # p -> f[p % tile]
        rep_g=lambda g: g.repeat_interleave(tile, dim=-1),          # p -> g[p // tile]
    )                                                               # [B, L, P]
    G = torch.exp(torch.clamp_max(power, 0.0))
    alpha_raw = torch.clamp_max(rows[..., 5:6] * G, ALPHA_SAT)
    skip = (power > 0.0) | (alpha_raw < ALPHA_MIN) | ~valid[..., None]
    alpha = torch.where(skip, 0.0, alpha_raw)
    return alpha, dict(rows=rows, colors=rows[..., 6:], idx=idx, valid=valid, G=G, skip=skip,
                       tx0=tx0, ty0=ty0)


def _batches(counts: np.ndarray, per_tile: int, budget: int):
    """Consecutive tile ranges [t0, t1) whose padded [t1-t0, L, per_tile] work
    stays within `budget` elements (a single tile may exceed it)."""
    t0 = 0
    T = counts.shape[0]
    while t0 < T:
        t1, lmax = t0 + 1, max(int(counts[t0]), 1)
        while t1 < T:
            lnew = max(lmax, int(counts[t1]))
            if (t1 + 1 - t0) * lnew * per_tile > budget:
                break
            t1, lmax = t1 + 1, lnew
        yield t0, t1, lmax
        t0 = t1


def composite_forward(feat: torch.Tensor, tile_start: torch.Tensor, tile_end: torch.Tensor,
                      bg: torch.Tensor, grid_x: int, grid_y: int, tile: int = 16,
                      budget: int = 1 << 24):
    """Composite all tiles.

    Args:
        feat: [D, 6 + C] entry rows in sorted order: mx, my, conic a, b, c,
            opacity, C colors.
        tile_start, tile_end: [T] entry range of each tile (T = grid_x * grid_y).
        bg: [C] background.
        budget: elements of each [tiles, entries, pixels] batch (memory knob).
    Returns:
        (tiles_rgb [T, P, C], tiles_tfin [T, P]).
    """
    T, P, C = grid_x * grid_y, tile * tile, feat.shape[1] - 6
    dev = feat.device
    out_rgb = torch.empty((T, P, C), dtype=torch.float32, device=dev)
    out_tfin = torch.empty((T, P), dtype=torch.float32, device=dev)
    counts = tile_end - tile_start
    for t0, t1, length in _batches(counts.cpu().numpy(), P, budget):
        tids = torch.arange(t0, t1, device=dev)
        alpha, aux = _tile_batch(feat, tile_start[t0:t1], counts[t0:t1], tids,
                                 grid_x, tile, length)
        colors = aux["colors"]
        one_m, P_prev, include, w, T_fin = _transmittance(alpha)
        color = torch.stack([(w * colors[..., c:c + 1]).sum(dim=1) for c in range(C)],
                            dim=-1)                                 # [B, P, C]
        out_rgb[t0:t1] = color + T_fin[..., None] * bg
        out_tfin[t0:t1] = T_fin
    return out_rgb, out_tfin


def composite_forward_packed(feat: torch.Tensor, tile_start: torch.Tensor,
                             tile_end: torch.Tensor, bg: torch.Tensor, grid_x: int,
                             grid_y: int, tile: int = 16, budget: int = 1 << 24):
    """`composite_forward` of packed entry rows: feat [D, 8] (mean2d, conic,
    opacity, packed R|B, G), each row unpacked once by `unpack_rb`; bg [3].
    Returns (tiles_rgb [T, P, 3], tiles_tfin [T, P])."""
    if feat.ndim != 2 or feat.shape[1] != 8:
        raise ValueError(f"packed entry rows are [D, 8], got {list(feat.shape)}")
    rows = torch.cat([feat[:, :6], unpack_rb(feat[:, 6], feat[:, 7])], dim=-1)
    return composite_forward(rows, tile_start, tile_end, bg, grid_x, grid_y, tile, budget)


def _transmittance(alpha):
    """The front-to-back recurrence of a batch: (1 - alpha, P_{g-1}, include,
    weights w [B, L, P], T_final [B, P])."""
    one_m = 1.0 - alpha
    P_inc = torch.cumprod(one_m, dim=1)                             # [B, L, P]
    P_prev = torch.cat([torch.ones_like(P_inc[:, :1]), P_inc[:, :-1]], dim=1)
    include = P_inc >= T_EPS
    w = torch.where(include, alpha * P_prev, 0.0)
    T_fin = torch.prod(torch.where(include, one_m, 1.0), dim=1)     # [B, P]
    return one_m, P_prev, include, w, T_fin


def composite_backward(feat: torch.Tensor, tile_start: torch.Tensor, tile_end: torch.Tensor,
                       bg: torch.Tensor, grid_x: int, grid_y: int, g_tiles: torch.Tensor,
                       g_tfin: torch.Tensor, tile: int = 16, budget: int = 1 << 24):
    """Analytic backward of `composite_forward`.

    Args:
        g_tiles: [T, P, C] cotangent of the tile colors; g_tfin: [T, P] of T_final.
    Returns:
        (d_feat [D, 6 + C], zero on rows no tile range reaches and on entries
        past a pixel's termination; d_bg [C]).
    """
    P, C = tile * tile, feat.shape[1] - 6
    dev = feat.device
    d_feat = torch.zeros_like(feat)
    d_bg = torch.zeros((C,), dtype=torch.float32, device=dev)
    counts = tile_end - tile_start
    for t0, t1, length in _batches(counts.cpu().numpy(), P, budget):
        tids = torch.arange(t0, t1, device=dev)
        alpha, aux = _tile_batch(feat, tile_start[t0:t1], counts[t0:t1], tids,
                                 grid_x, tile, length)
        one_m, P_prev, include, w, T_fin = _transmittance(alpha)
        colors, rows = aux["colors"], aux["rows"]
        gbar = g_tiles[t0:t1]                                       # [B, P, C]
        cdotg = colors[..., 0:1] * gbar[:, None, :, 0]
        for c in range(1, C):
            cdotg = cdotg + colors[..., c:c + 1] * gbar[:, None, :, c]  # [B, L, P]
        Q = torch.cumsum(w * cdotg, dim=1)                          # inclusive prefix
        S = Q[:, -1:] - Q                                           # suffix over j > g
        Bv = gbar[..., 0] * bg[0]
        for c in range(1, C):
            Bv = Bv + gbar[..., c] * bg[c]
        Bv = Bv + g_tfin[t0:t1]                                     # [B, P]
        contrib = include & ~aux["skip"]
        d_alpha = torch.where(contrib,
                              P_prev * cdotg - (S + (T_fin * Bv)[:, None, :]) / one_m, 0.0)
        G = aux["G"]
        op = rows[..., 5:6]
        dG = op * d_alpha                                           # saturation unmasked
        pix = torch.arange(P, device=dev)
        px = aux["tx0"] + (pix % tile).to(torch.float32)            # [B, P] absolute
        py = aux["ty0"] + (pix // tile).to(torch.float32)
        dx = rows[..., 0:1] - px[:, None, :]                        # [B, L, P]
        dy = rows[..., 1:2] - py[:, None, :]
        gdx = G * dx
        gdy = G * dy
        ca, cb, cc = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5]
        d_rows = [
            torch.sum(dG * (-(gdx * ca + gdy * cb)), dim=-1),        # mean2d x
            torch.sum(dG * (-(gdy * cc + gdx * cb)), dim=-1),        # mean2d y
            torch.sum(-0.5 * gdx * dx * dG, dim=-1),                 # conic a
            torch.sum(-(gdx * dy) * dG, dim=-1),                     # conic b
            torch.sum(-0.5 * gdy * dy * dG, dim=-1),                 # conic c
            torch.sum(G * d_alpha, dim=-1),                          # opacity
        ] + [torch.sum(w * gbar[:, None, :, c], dim=-1) for c in range(C)]
        d_rows = torch.stack(d_rows, dim=-1)                        # [B, L, 6 + C]
        valid = aux["valid"]
        d_feat[aux["idx"][valid]] = d_rows[valid]
        d_bg += torch.sum(T_fin[..., None] * gbar, dim=(0, 1))
    return d_feat, d_bg
