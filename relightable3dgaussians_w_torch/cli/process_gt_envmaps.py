"""Preprocess GT environment maps: image -> SH coefficient txt / npy + preview.

Port of the JAX package's `cli/process_gt_envmaps.py` (the reference's
`process_gt_envmaps.py`), on this package's SH projection and rotation
(utils/envmap.py). Host-only numpy work; reading .exr needs OpenCV.

Usage:
    python -m relightable3dgaussians_w_torch.cli.process_gt_envmaps --input=DIR \\
        [--output=DIR] [--deg=4] [--rotate_x=1]
"""

from __future__ import annotations

import os
import sys

import numpy as np
from PIL import Image

from ..utils import envmap as EM
from .render import save_image


def process_dir(in_dir: str, out_dir: str, deg: int = 4, rotate_x: bool = True):
    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(os.listdir(in_dir)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png", ".exr")):
            continue
        path = os.path.join(in_dir, name)
        if name.lower().endswith(".exr"):
            import cv2

            img = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)[..., ::-1]
            img = np.asarray(img, np.float32)
        else:
            img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        coeffs = EM.project_envmap_to_sh(img, deg)
        if rotate_x:
            coeffs = EM.rotate_sh(coeffs, roll=-np.pi / 2)
        stem = os.path.splitext(name)[0]
        np.savetxt(os.path.join(out_dir, stem + "_sh.txt"), coeffs)
        np.save(os.path.join(out_dir, stem + "_sh.npy"), coeffs)
        preview = EM.render_sh_map(coeffs, width=512, convolve_diffuse=False)
        save_image(os.path.join(out_dir, stem + "_recon.png"), np.clip(preview, 0, 1))
        print(f"processed {name}")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    kwargs = {a.split("=", 1)[0].lstrip("-"): a.split("=", 1)[1] for a in argv if "=" in a}
    process_dir(
        kwargs["input"], kwargs.get("output", kwargs["input"] + "_sh"),
        deg=int(kwargs.get("deg", 4)),
        rotate_x=kwargs.get("rotate_x", "1") == "1",
    )


if __name__ == "__main__":
    main()
