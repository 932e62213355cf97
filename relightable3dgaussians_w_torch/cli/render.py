"""Render CLI: train and test sets with every AOV and each image's illumination.

Port of the JAX package's `cli/render.py` (the reference's `render_set`): per
view the render, the ground truth and every AOV of one fused 21-channel pass
(diffuse, specular, depth, normal, sky color, roughness, metalness, albedo),
plus equirect reconstructions of the view's environment light and sky SH.
Test views render with embeddings fitted on their left halves
(`evaluation.optimize_test_embeddings`, from a normal init).

Usage:
    python -m relightable3dgaussians_w_torch.cli.render dataset.source_path=... \\
        dataset.model_path=... model.load_iteration=N [--skip_train] [--skip_test] \\
        [--device=cpu]

With several visible cards each frame's tile rows are split over them
(`make_eval_raster_fn`, `parallel/tile_parallel.py`), a bitwise-equal
decomposition; one card renders whole frames.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
from PIL import Image
from torch.func import functional_call

from ..config import load_config
from ..utils import envmap as EM
from ..utils.sh import gamma_correction
from ..utils.viridis import viridis

AOV_DIRS = ("renders", "gts", "rendered_envlights", "rendered_sky_maps", "diffuse_color",
            "specular_color", "depth", "normal", "sky_color", "roughness", "metalness",
            "albedo")


def save_image(path: str, arr: np.ndarray):
    """arr: [H, W, 3] or [H, W] float in [0, 1]."""
    arr = np.clip(np.asarray(arr), 0.0, 1.0)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def depth_colormap(depth: np.ndarray) -> np.ndarray:
    """Depth normalized between its 1st and 99th percentiles, colored by viridis."""
    d = np.asarray(depth, np.float32)
    lo, hi = np.percentile(d, 1), np.percentile(d, 99)
    d = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
    return viridis(d).astype(np.float32)


def split_args(argv):
    """(config overrides, --flags, device) of an eval CLI's argv."""
    device = "cuda"
    overrides, flags = [], {}
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--"):
            k, _, v = a[2:].partition("=")
            flags[k] = v
        else:
            overrides.append(a)
    return overrides, flags, device


def make_eval_raster_fn(rcfg, device):
    """Tile-parallel rendering over the visible CUDA devices, with the largest
    band count up to their number that divides grid_y. None with one device
    (or the CPU), or when no count above 1 divides grid_y."""
    dev = torch.device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n <= 1:
        return None
    gy = rcfg.grid_y
    k = max(k for k in range(1, n + 1) if gy % k == 0)
    if k <= 1:
        return None
    from ..parallel.tile_parallel import make_tile_parallel_raster_fn

    print(f"render: tile-parallel over {k} devices ({gy // k} tile rows each)")
    return make_tile_parallel_raster_fn([torch.device("cuda", i) for i in range(k)])


def load_trainer(overrides, device):
    """The trainer of a config, with `model.load_iteration`'s checkpoint loaded.
    Returns (trainer, iteration)."""
    from ..trainer import Relightable3DGWTrainer

    cfg = load_config(overrides)
    trainer = Relightable3DGWTrainer(cfg, device=device)
    iteration = cfg.model.load_iteration or 0
    if iteration:
        trainer.load_checkpoint(iteration)
    return trainer, iteration


@torch.no_grad()
def render_set(trainer, name: str, iteration: int, views, embeddings):
    """Render `views` (padded view dicts) under `embeddings` (row i for view i)
    into <model_path>/<name>/iteration_<iteration>/<AOV>/."""
    from ..renderer import render

    base_dir = os.path.join(trainer.model_path, name, f"iteration_{iteration}")
    dirs = {k: os.path.join(base_dir, k) for k in AOV_DIRS}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    cfg, dev = trainer.cfg, trainer.device
    raster_fn = make_eval_raster_fn(trainer.rcfg, dev)
    p = trainer.state.params
    m = cfg.model
    for i, view in enumerate(views):
        cam = view["cam"]
        envl, sky_sh = functional_call(trainer.mlp, p["mlp"], (embeddings[i][None].to(dev),))
        out = render(p["gaussians"], trainer.state.gauss_state, envl[0], sky_sh,
                     cam.matrices(dev), trainer.rcfg, trainer.bg_color,
                     torch.as_tensor(view["sky_mask"], device=dev), m.envlight_sh_degree,
                     m.sky_sh_degree, m.specular, m.fix_sky, debug=True, device=dev,
                     raster_fn=raster_fn)
        h, w, nm = cam.height, cam.width, cam.image_name
        img = lambda x: x.cpu().numpy()[:h, :w]
        save = lambda k, a: save_image(os.path.join(dirs[k], nm + ".png"), a)
        save("renders", img(out.render))
        save("gts", view["image"][:h, :w])
        save("diffuse_color", img(out.diffuse_color))
        save("specular_color", img(out.specular_color))
        save("depth", depth_colormap(-img(out.depth)))
        save("normal", 0.5 + 0.5 * img(out.normal))
        save("sky_color", img(out.sky_color))
        save("roughness", img(out.roughness))
        save("metalness", img(out.metalness))
        save("albedo", img(out.albedo))

        envl, sky_sh = envl[0].cpu().numpy(), sky_sh[0].cpu().numpy()
        np.save(os.path.join(dirs["rendered_envlights"], nm + ".npy"), envl)
        env_img = EM.render_sh_map(envl, width=600)
        save_image(os.path.join(dirs["rendered_envlights"], nm + ".jpg"),
                   gamma_correction(torch.as_tensor(env_img)).numpy())
        np.save(os.path.join(dirs["rendered_sky_maps"], nm + ".npy"), sky_sh)
        sky_img = EM.render_sh_map(sky_sh, width=600)
        save_image(os.path.join(dirs["rendered_sky_maps"], nm + ".jpg"), np.clip(sky_img, 0, 1))
        print(f"{name} [{i + 1}/{len(views)}] {nm}")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    overrides, flags, device = split_args(argv)
    trainer, iteration = load_trainer(overrides, device)
    cfg = trainer.cfg

    from ..trainer import pad_cameras

    if "skip_train" not in flags:
        render_set(trainer, "train", iteration, trainer.train_views,
                   trainer.state.params["embeddings"])
    if "skip_test" not in flags and trainer.test_cameras:
        from ..evaluation import optimize_test_embeddings

        test_views, _, _ = pad_cameras(trainer.test_cameras)
        # Normal init: zeros are a dead point of the ReLU MLP (no gradient).
        gen = torch.Generator().manual_seed(cfg.runtime.seed)
        init = torch.randn((len(test_views), cfg.model.embeddings_dim), generator=gen)
        emb_t = optimize_test_embeddings(trainer.state.params, trainer.state.gauss_state,
                                         trainer.mlp, test_views, cfg, trainer.rcfg, init,
                                         device=trainer.device)
        render_set(trainer, "test", iteration, test_views, emb_t)
    return trainer


if __name__ == "__main__":
    main()
