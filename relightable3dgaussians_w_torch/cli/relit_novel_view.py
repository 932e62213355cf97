"""Relight a trained scene with an external environment map from one view, over
a sweep of sun rotations.

Port of the JAX package's `cli/relit_novel_view.py` (the reference's
`relit_novel_view.py`): the envmap (.jpg/.png, .exr, or a learned .npy SH file)
is projected to SH, rendered with a white sky and rotated about y in `--steps`
equal steps; frames go to <model_path>/relit_novel_view/iteration_N/, and an
.mp4 too when imageio's ffmpeg plugin is installed (otherwise it says so and
keeps the frames). Reading .exr needs OpenCV, as in the JAX package.

Usage:
    python -m relightable3dgaussians_w_torch.cli.relit_novel_view dataset.source_path=... \\
        dataset.model_path=... model.load_iteration=N --envmap=sky.png [--view=NAME] \\
        [--steps=30] [--device=cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..utils import envmap as EM
from .render import load_trainer, save_image, split_args


def load_envmap_sh(path: str, deg: int) -> np.ndarray:
    """[(deg+1)**2, 3] SH of an envmap image, or the leading rows of a saved .npy."""
    if path.endswith(".npy"):
        return np.load(path).reshape(-1, 3)[: (deg + 1) ** 2]
    if path.endswith(".exr"):
        import cv2

        img = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)[..., ::-1]
    else:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return EM.project_envmap_to_sh(np.asarray(img, np.float32), deg)


@torch.no_grad()
def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    overrides, flags, device = split_args(argv)
    trainer, iteration = load_trainer(overrides, device)
    cfg, dev = trainer.cfg, trainer.device
    m = cfg.model

    from ..renderer import render
    from ..trainer import pad_cameras

    n_steps = int(flags.get("steps", 30))
    views, _, _ = pad_cameras(trainer.test_cameras or trainer.train_cameras)
    view = next((v for v in views if v["cam"].image_name == flags.get("view")), views[0])
    base0 = load_envmap_sh(flags["envmap"], m.envlight_sh_degree)

    out_dir = os.path.join(trainer.model_path, "relit_novel_view", f"iteration_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    sky_sh = torch.zeros((1, (m.sky_sh_degree + 1) ** 2, 3), device=dev)
    cam = view["cam"].matrices(dev)
    sky = torch.as_tensor(view["sky_mask"], device=dev)
    h, w = view["cam"].height, view["cam"].width
    frames = []
    for i in range(n_steps):
        base = torch.as_tensor(EM.rotate_sh(base0, pitch=2 * np.pi * i / n_steps), device=dev)
        out = render(trainer.state.params["gaussians"], trainer.state.gauss_state, base, sky_sh,
                     cam, trainer.rcfg, trainer.bg_color, sky, m.envlight_sh_degree,
                     m.sky_sh_degree, m.specular, fix_sky=True, debug=False, device=dev)
        img = torch.clamp(out.render, 0, 1).cpu().numpy()[:h, :w]
        save_image(os.path.join(out_dir, f"frame_{i:03d}.png"), img)
        frames.append((img * 255).astype(np.uint8))
        print(f"frame {i + 1}/{n_steps}")

    try:
        import imageio.v3 as iio

        iio.imwrite(os.path.join(out_dir, "relit_sweep.mp4"), np.stack(frames), fps=10)
    except Exception as e:  # imageio or its ffmpeg plugin absent: the frames stay
        print(f"video export skipped: {e}")
    return out_dir


if __name__ == "__main__":
    main()
