"""White-light evaluation CLI: port of the JAX package's `cli/eval_white_light.py`
(the reference's `eval_with_white_light.py`). Renders every test view (or every
train view when there are none) under uniform white light, scores it against
the occluder-masked ground truth and writes
<model_path>/white_light/iteration_N/{<view>.png, results.json}.

Usage:
    python -m relightable3dgaussians_w_torch.cli.eval_white_light dataset.source_path=... \\
        dataset.model_path=... model.load_iteration=N [--device=cpu]
"""

from __future__ import annotations

import json
import os
import sys

import torch

from ..evaluation import eval_white_light
from ..utils import losses as LO
from .render import load_trainer, save_image, split_args


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    overrides, _, device = split_args(argv)
    trainer, iteration = load_trainer(overrides, device)

    from ..trainer import pad_cameras

    views, _, _ = pad_cameras(trainer.test_cameras or trainer.train_cameras)
    out_dir = os.path.join(trainer.model_path, "white_light", f"iteration_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for view in views:
        img = eval_white_light(trainer.state.params, trainer.state.gauss_state, trainer.cfg,
                               trainer.rcfg, view, device=trainer.device)
        nm = view["cam"].image_name
        h, w = view["cam"].height, view["cam"].width
        save_image(os.path.join(out_dir, nm + ".png"), img[:h, :w])
        chw = lambda a: torch.as_tensor(a[:h, :w]).movedim(-1, 0)
        occ = torch.as_tensor(view["occluders_mask"][:h, :w])[None]
        results[nm] = {"psnr": float(LO.mse2psnr(LO.img2mse(chw(img), chw(view["image"]),
                                                            mask=occ)))}
        print(nm, results[nm])
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
