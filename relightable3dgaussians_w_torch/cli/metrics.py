"""Metrics CLI: PSNR / SSIM (/ LPIPS) over saved render and ground-truth folders.

Port of the JAX package's `cli/metrics.py` (the reference's `metrics.py`
`evaluate` and its right-half `evaluate_half` protocol). Writes
<model_path>/results.json (per split and iteration) and a per_view.json beside
each renders folder; LPIPS is `null`, with the reason in `lpips_reason`, when
its VGG16 weights are not present.

Usage:
    python -m relightable3dgaussians_w_torch.cli.metrics <model_path> ... [--half] \\
        [--device=cpu]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
from PIL import Image

from ..device import resolve_device
from ..models.lpips import make_lpips_fn
from ..utils import losses as LO

LPIPS_REASON = ("weights unavailable: models/_lpips_vgg16.npz missing "
                "(no torchvision/network in this environment; produce "
                "it with models/lpips.convert_torch_weights)")


def _read_dir(path: str) -> dict[str, np.ndarray]:
    out = {}
    for name in sorted(os.listdir(path)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        with Image.open(os.path.join(path, name)) as im:
            out[os.path.splitext(name)[0]] = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return out


@torch.no_grad()
def evaluate_dir(renders_dir: str, gt_dir: str, half: bool = False,
                 lpips_weights: str | None = None, device: str | torch.device = "cuda") -> dict:
    """Per-view and mean PSNR / SSIM / MSE / LPIPS of the renders that have a
    ground truth of the same name; with `half`, of the right halves only."""
    dev = resolve_device(device)
    renders = _read_dir(renders_dir)
    gts = _read_dir(gt_dir)
    lpips_fn = make_lpips_fn(lpips_weights)
    if lpips_fn is None:
        print(f"LPIPS skipped: {LPIPS_REASON}")
    per_view = {}
    for name, im in renders.items():
        if name not in gts:
            continue
        gt = gts[name]
        if half:
            im = im[:, im.shape[1] // 2:]
            gt = gt[:, gt.shape[1] // 2:]
        imc = torch.as_tensor(im, device=dev).movedim(-1, 0)
        gtc = torch.as_tensor(gt, device=dev).movedim(-1, 0)
        per_view[name] = {
            "psnr": float(LO.psnr(imc, gtc)),
            "ssim": float(LO.ssim(imc, gtc)),
            "mse": float(LO.img2mse(imc, gtc)),
            # null, not absent, when the metric cannot run
            "lpips": float(lpips_fn(imc, gtc)) if lpips_fn is not None else None,
        }
    keys = next(iter(per_view.values())).keys() if per_view else []
    summary = {
        k: (float(np.mean([v[k] for v in per_view.values()]))
            if all(v[k] is not None for v in per_view.values()) else None)
        for k in keys
    }
    if lpips_fn is None:
        summary["lpips_reason"] = LPIPS_REASON
    return {"summary": summary, "per_view": per_view}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    half = "--half" in argv
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), "cuda")
    paths = [a for a in argv if not a.startswith("--")]
    out = {}
    for mp in paths or ["./output/run"]:
        results = {}
        for split in ("train", "test"):
            split_dir = os.path.join(mp, split)
            if not os.path.isdir(split_dir):
                continue
            for it_dir in sorted(os.listdir(split_dir)):
                renders = os.path.join(split_dir, it_dir, "renders")
                gts = os.path.join(split_dir, it_dir, "gts")
                if os.path.isdir(renders) and os.path.isdir(gts):
                    res = evaluate_dir(renders, gts, half=half and split == "test",
                                       device=device)
                    results[f"{split}/{it_dir}"] = res["summary"]
                    with open(os.path.join(split_dir, it_dir, "per_view.json"), "w") as f:
                        json.dump(res["per_view"], f, indent=2)
        with open(os.path.join(mp, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        print(json.dumps(results, indent=2))
        out[mp] = results
    return out


if __name__ == "__main__":
    main()
