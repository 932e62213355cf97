"""GT-envmap relighting evaluation CLI.

Port of the JAX package's `cli/eval_gt_envmaps.py` (the reference's
`eval_with_gt_envmaps.py`): per test view named in the test config, project its
GT envmap to SH (with saturation boosting), apply the scene's initial rotation,
sweep 51 sun angles about y, keep the best masked PSNR, and write
<model_path>/relit_gt_envmaps/iteration_N/{<view>.png, metrics.txt}.

Test configs are `test_config.json`, or a `test_config.py` with a `config`
dict, in `dataset.test_config_path`. The evaluation mask is resized to the
render size and eroded by a 5x5 square here, with OpenCV's `resize`
(INTER_LINEAR, uint8 fixed point) and `erode` arithmetic, so OpenCV is not
needed.

Usage:
    python -m relightable3dgaussians_w_torch.cli.eval_gt_envmaps dataset.source_path=... \\
        dataset.model_path=... dataset.eval=true dataset.test_config_path=... \\
        model.load_iteration=N [--device=cpu]
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import numpy as np
from PIL import Image

from ..evaluation import eval_view_with_gt_envmap
from .render import load_trainer, save_image, split_args

_COEF_SCALE = 2048   # OpenCV's INTER_RESIZE_COEF_SCALE (11 fractional bits)


def load_test_config(path: str) -> dict:
    """The per-view test config of a folder: test_config.json, else the
    `config` dict of test_config.py."""
    jpath = os.path.join(path, "test_config.json")
    if os.path.exists(jpath):
        with open(jpath) as f:
            return json.load(f)
    ppath = os.path.join(path, "test_config.py")
    spec = importlib.util.spec_from_file_location("test_config", ppath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.config


def _erode(mask: np.ndarray, k: int = 5, iterations: int = 1) -> np.ndarray:
    """Erosion of a uint8 image by a k x k square, as `cv2.erode` with its
    default border (nothing outside the image erodes it)."""
    m = np.asarray(mask, np.uint8)
    r = k // 2
    for _ in range(iterations):
        win = np.lib.stride_tricks.sliding_window_view(np.pad(m, r, constant_values=255), (k, k))
        m = win.min(axis=(-2, -1))
    return m


def _linear_taps(dst: int, src: int, clamp_weights: bool):
    """Source indices and 11-bit weights of OpenCV's INTER_LINEAR along one
    axis. Columns past the edges take the edge pixel at full weight; rows keep
    their weights and clamp only the row index."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp_weights:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0.0
        s = np.where(s < 0, 0, np.where(s >= src - 1, src - 1, s))
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W] uint8 -> [height, width] uint8 with the arithmetic of
    `cv2.resize(img, (width, height))`: an exact 2x shrink averages 2 x 2 blocks;
    otherwise 11-bit fixed-point weights, a horizontal pass in integers, and the
    vertical pass of OpenCV's SIMD path ((row >> 4) * w >> 16 per row, then
    (sum + 2) >> 2)."""
    src = np.asarray(img, np.uint8).astype(np.int64)
    H, W = src.shape
    if (W, H) == (2 * width, 2 * height):
        return ((src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + src[1::2, 1::2] + 2)
                >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(width, W, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(height, H, clamp_weights=False)
    rows = src[:, x0] * a0 + src[:, x1] * a1
    out = (((rows[y0] >> 4) * b0[:, None]) >> 16) + (((rows[y1] >> 4) * b1[:, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def eval_mask(mask_path: str, width: int, height: int) -> np.ndarray:
    """The {0, 1} float32 evaluation mask of a test view at the render size."""
    mask = np.asarray(Image.open(mask_path).convert("L"), np.uint8)
    return (_erode(resize_linear_u8(mask, width, height)) // 255).astype(np.float32)


def load_envmap(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    overrides, _, device = split_args(argv)
    trainer, iteration = load_trainer(overrides, device)
    cfg = trainer.cfg

    from ..trainer import pad_cameras

    test_config = load_test_config(cfg.dataset.test_config_path)
    names = {k.split(".")[0] for k in test_config}
    views, _, _ = pad_cameras([c for c in trainer.test_cameras if c.image_name in names])

    out_dir = os.path.join(trainer.model_path, "relit_gt_envmaps", f"iteration_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    metrics_lines, psnrs, results = [], [], {}
    for view in views:
        nm = view["cam"].image_name
        icfg = next(v for k, v in test_config.items() if k.split(".")[0] == nm)
        rot = icfg["initial_env_map_rotation"]
        res = eval_view_with_gt_envmap(
            trainer.state.params, trainer.state.gauss_state, cfg, trainer.rcfg, view,
            load_envmap(icfg["env_map_path"]),
            eval_mask(icfg["mask_path"], trainer.W, trainer.H),
            init_rot=(rot["x"], rot["y"], rot["z"]),
            sun_angle_range=tuple(icfg["sun_angles"]),
            threshold=icfg["env_map_scaling"]["threshold"],
            scale=icfg["env_map_scaling"]["scale"], device=trainer.device)
        h, w = view["cam"].height, view["cam"].width
        save_image(os.path.join(out_dir, nm + ".png"), res.image[:h, :w])
        line = (f"{nm}: PSNR {res.psnr:.3f} MAE {res.mae:.5f} MSE {res.mse:.6f} "
                f"best_angle {res.best_angle:.3f}")
        print(line)
        metrics_lines.append(line)
        psnrs.append(res.psnr)
        results[nm] = res
    metrics_lines.append(f"mean PSNR: {np.mean(psnrs):.3f}")
    with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
        f.write("\n".join(metrics_lines) + "\n")
    return results


if __name__ == "__main__":
    main()
