"""GT-envmap evaluation over every test view, grouped by lighting condition.

Port of the JAX package's `cli/eval_gt_envmaps_all.py` (the reference's
`eval_with_gt_envmaps_all.py`): each test view whose lighting condition has a GT
envmap in the test config is relit with it (one envmap serves every view of
its condition); `--random_sun` uses one random sun angle per view instead of
the best-of-51 sweep. Writes
<model_path>/relit_gt_envmaps_all/iteration_N/{<view>.png, results.json}.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..evaluation import eval_view_with_gt_envmap
from .eval_gt_envmaps import eval_mask, load_envmap, load_test_config
from .render import load_trainer, save_image, split_args


def lighting_condition_of(image_name: str) -> str:
    """Lighting-condition prefix of a NeRF-OSR image name (a copy of the JAX
    package's `pretrain.lighting_condition_of`)."""
    return image_name[:3] if image_name.startswith("C") else image_name[:-9]


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    overrides, flags, device = split_args(argv)
    random_sun = "random_sun" in flags
    trainer, iteration = load_trainer(overrides, device)
    cfg = trainer.cfg

    from ..trainer import pad_cameras

    test_config = load_test_config(cfg.dataset.test_config_path)
    by_condition = {lighting_condition_of(k.split(".")[0]): v for k, v in test_config.items()}
    views, _, _ = pad_cameras(trainer.test_cameras)

    out_dir = os.path.join(trainer.model_path, "relit_gt_envmaps_all", f"iteration_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    results = {}
    for view in views:
        nm = view["cam"].image_name
        icfg = by_condition.get(lighting_condition_of(nm))
        if icfg is None:
            continue
        rot = icfg["initial_env_map_rotation"]
        lo, hi = icfg["sun_angles"]
        if random_sun:
            a = float(rng.uniform(lo, hi))
            sweep = dict(sun_angle_range=(a, a), n_angles=1)
        else:
            sweep = dict(sun_angle_range=(lo, hi), n_angles=51)
        res = eval_view_with_gt_envmap(
            trainer.state.params, trainer.state.gauss_state, cfg, trainer.rcfg, view,
            load_envmap(icfg["env_map_path"]),
            eval_mask(icfg["mask_path"], trainer.W, trainer.H),
            init_rot=(rot["x"], rot["y"], rot["z"]),
            threshold=icfg["env_map_scaling"]["threshold"],
            scale=icfg["env_map_scaling"]["scale"], device=trainer.device, **sweep)
        h, w = view["cam"].height, view["cam"].width
        save_image(os.path.join(out_dir, nm + ".png"), res.image[:h, :w])
        results[nm] = {"psnr": res.psnr, "mae": res.mae, "mse": res.mse,
                       "angle": res.best_angle}
        print(nm, results[nm])
    if results:
        results["mean"] = {k: float(np.mean([v[k] for n, v in results.items() if n != "mean"]))
                           for k in ("psnr", "mae", "mse")}
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
