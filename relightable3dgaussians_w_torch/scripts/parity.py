"""Card parity probe: the rasterizer's kernels on the card against the plain
PyTorch path on the CPU, at a size where the discontinuous predicates flip.

Port of the JAX repo's `scripts/tpu_parity.py`. The skip and termination
predicates (power > 0, alpha < 1/255, T < 1e-4) flip at about one pixel in
50M (pixel, entry) pairs when two implementations round one op differently,
so a CPU test at a toy size cannot see them: this probe renders the
`bench.build` scene at PARITY_N Gaussians (default 50,000) and PARITY_RES^2
(default 512) once on the card and once on the CPU, and compares the image
and the gradients of the five input groups (means, scales, quats,
opacities, colors) under the JAX script's weighted loss, sum(image *
sin(0.37 * pixel index)) + 0.5 * sum(alpha), which gives every pixel and
channel its own cotangent.

Budgets (the JAX script's): image max |delta| <= PARITY_IMG_TOL (5e-4), each
gradient's max |delta| / max |CPU| <= PARITY_GRAD_TOL (3e-3), and zero
entry overflow on both sides. Both sides share one RasterizerConfig (so one
entry budget); the BENCH_* knobs of `bench.build` apply.

    python -m relightable3dgaussians_w_torch.scripts.parity [--device=cpu]

Prints ONE JSON line {"ok": bool, ...} and exits 1 unless ok. With
--device=cpu both sides run on the CPU (a check of the probe itself).
Env: PARITY_N, PARITY_RES, PARITY_SEED (0), PARITY_IMG_TOL, PARITY_GRAD_TOL.
`BENCH_PARITY=1` makes `bench.py` call `run(quiet=True)`.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from ..device import card_line, resolve_device
from ..ops.rasterize import CameraMatrices, rasterize

GROUPS = ("means", "scales", "quats", "opacities", "colors")


def _render_grads(arrs, cam, cfg, dev):
    """(image, overflow, the five gradients) of the weighted loss rendered on
    `dev`, the tensors moved to the CPU."""
    leaves = [a.detach().to(dev).requires_grad_(True) for a in arrs]
    cam = CameraMatrices(*[x.to(dev) for x in cam])
    img, aux = rasterize(*leaves, torch.zeros(3, device=dev), cam, cfg, device=dev)
    hw = torch.arange(img.numel(), dtype=torch.float32, device=dev).reshape(img.shape)
    loss = (img * torch.sin(hw * 0.37)).sum() + 0.5 * aux.alpha.sum()
    grads = torch.autograd.grad(loss, leaves)
    return img.detach().cpu(), int(aux.overflow), [g.cpu() for g in grads]


def run(n=None, res=None, seed=None, quiet=False, device="cuda"):
    """The parity report {"ok", "image_max_abs", "overflow", "grad_<group>_rel",
    "n", "res", "backend", "card"}; printed unless quiet."""
    from .bench import build

    dev = resolve_device(device)
    n = n or int(os.environ.get("PARITY_N", 50_000))
    res = res or int(os.environ.get("PARITY_RES", 512))
    seed = seed if seed is not None else int(os.environ.get("PARITY_SEED", 0))
    img_tol = float(os.environ.get("PARITY_IMG_TOL", 5e-4))
    grad_tol = float(os.environ.get("PARITY_GRAD_TOL", 3e-3))

    arrs, cam, cfg = build(n, res, res, seed=seed, device="cpu")
    cfg = cfg._replace(packed_rgb=False)   # the differentiable path
    img_k, ov_k, g_k = _render_grads(arrs, cam, cfg, dev)
    img_p, ov_p, g_p = _render_grads(arrs, cam, cfg, torch.device("cpu"))

    img_err = float((img_k.double() - img_p.double()).abs().max())
    report = {"image_max_abs": img_err, "overflow": max(ov_k, ov_p)}
    ok = img_err <= img_tol and ov_k == 0 and ov_p == 0
    for name, a, b in zip(GROUPS, g_k, g_p):
        a, b = a.double(), b.double()
        rel = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-12)
        report[f"grad_{name}_rel"] = rel
        ok = ok and rel <= grad_tol
    report.update(ok=bool(ok), n=n, res=res, max_dup=cfg.max_dup, backend=dev.type,
                  card=card_line(dev))
    if not quiet:
        print(json.dumps(report), flush=True)
    return report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = dict(a.split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    if set(flags) - {"--device"} or len(flags) != len(argv):
        raise SystemExit(f"usage: parity [--device=cpu] (got {argv})")
    return 0 if run(device=flags.get("--device", "cuda"))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
