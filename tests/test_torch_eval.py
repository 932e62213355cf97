"""The torch port's evaluation / relighting slice against the JAX package, on
the CPU.

Same numpy inputs through both packages (the port with device="cpu"): the
envmap <-> SH utilities (1e-5), the left-half test-embedding fit (3 Adam steps
from one init), the fused GT-envmap sun sweep (same best angle, per-angle PSNR
within 1e-3 dB, image within the kernel tolerance of tests/test_torch_ops.py),
white light, the half-image metrics, LPIPS on synthetic weights (1e-5), the
evaluation mask's resize and erosion against OpenCV (bitwise), the depth
colormap against matplotlib (bitwise), and the CLI chain
train -> render -> metrics --half -> GT-envmap evaluation through
`cli.full_eval` on a tiny dataset. The JAX references are computed once per
module.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import __graft_entry__ as ge
from relightable3dgaussians_w_tpu import evaluation as jevaluation
from relightable3dgaussians_w_tpu import renderer as jrenderer
from relightable3dgaussians_w_tpu.cli import render as jrender_cli
from relightable3dgaussians_w_tpu.data.cameras import Camera as JCamera
from relightable3dgaussians_w_tpu.models import lpips as jlpips
from relightable3dgaussians_w_tpu.models.nets import MLPNet as JMLPNet
from relightable3dgaussians_w_tpu.ops.rasterize import RasterizerConfig as JRasterizerConfig
from relightable3dgaussians_w_tpu.utils import envmap as jenvmap

from relightable3dgaussians_w_torch import convert, evaluation
from relightable3dgaussians_w_torch.cli import (eval_gt_envmaps, eval_gt_envmaps_all,
                                                eval_white_light, full_eval, process_gt_envmaps,
                                                relit_novel_view, render as render_cli)
from relightable3dgaussians_w_torch.config import Config
from relightable3dgaussians_w_torch.data.cameras import Camera
from relightable3dgaussians_w_torch.models import lpips
from relightable3dgaussians_w_torch.models.nets import MLPNet
from relightable3dgaussians_w_torch.ops.rasterize import RasterizerConfig
from relightable3dgaussians_w_torch.utils import envmap

from test_lpips import synth_weights
from test_torch_ops import assert_image_close
from test_trainer_e2e import make_dataset
import _torch_threads

_torch_threads.share_cores()

W = H = 64
ATOL = 1e-5
# 3 Adam steps of lr 2e-4 move an embedding by <= 6e-4 (4.4e-4 here). The two
# packages' fits came out equal to the bit on this scene; 1e-6 leaves room for
# float32 renders that differ in the last bits, which Adam's normalized steps
# would carry into the embeddings.
EMB_ATOL = 1e-6


def _views(seed, names):
    """The same padded test views for both packages (JAX's and the port's Camera)."""
    rng = np.random.RandomState(seed)
    out = []
    for name in names:
        img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        occ = np.ones((H, W), np.float32)
        occ[:, 5:9] = 0.0
        kw = dict(uid=0, colmap_id=0, R=np.eye(3), T=np.zeros(3), fovx=np.deg2rad(60),
                  fovy=np.deg2rad(60), image_name=name, image=None, sky_mask=None,
                  occluders_mask=None, width=W, height=H)
        views = [dict(cam=cls(**kw), image=img, sky_mask=np.ones((H, W), np.float32),
                      occluders_mask=occ) for cls in (JCamera, Camera)]
        out.append(views)
    return [v[0] for v in out], [v[1] for v in out]


def _sun_envmap():
    """A 32 x 64 equirect sky: dim noise and one saturated sun, so the sweep's
    sun angles light the scene differently."""
    rng = np.random.RandomState(5)
    env = rng.uniform(0.02, 0.1, (32, 64, 3)).astype(np.float32)
    yy, xx = np.mgrid[:32, :64]
    env[np.hypot(yy - 9, xx - 20) < 4] = 1.0
    return env


class _ArgmaxRecorder:
    """Stands in for numpy in the JAX evaluation module: records the per-angle
    PSNRs that `eval_view_with_gt_envmap` picks its best angle from."""

    def __init__(self):
        self.inputs = []

    def __getattr__(self, name):
        return getattr(np, name)

    def argmax(self, a, *args, **kwargs):
        self.inputs.append(np.array(a))
        return np.argmax(a, *args, **kwargs)


def _mlp_params(seed=0, dims=(32, 256, 256, 128, 12, 128, 75)):
    """Flax-layout MLPNet weights (LeCun-normal kernels, small biases) from numpy."""
    rng = np.random.RandomState(seed)
    shapes = [(dims[0], dims[1]), (dims[1], dims[2]), (dims[2], dims[3]), (dims[3], dims[4]),
              (dims[3], dims[5]), (dims[5], dims[6])]
    return {f"Dense_{i}": {"kernel": (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32),
                           "bias": rng.uniform(0, 0.05, s[1]).astype(np.float32)}
            for i, s in enumerate(shapes)}


@pytest.fixture(scope="module")
def ref():
    """A 300 + 40 sky Gaussian scene with numpy MLP weights in both packages, and
    every JAX result the tests compare with. JAX's `render` runs jitted inside
    the JAX evaluation functions (one compile instead of op-by-op ones)."""
    cfg = Config()
    p, s = ge._synthetic_scene(n=300, n_sky=40)
    mlp = _mlp_params()
    params = {"gaussians": p, "mlp": mlp, "embeddings": jnp.zeros((2, 32), jnp.float32)}
    jrcfg = JRasterizerConfig(width=W, height=H, max_dup=1 << 14, max_tiles_per_gauss=32,
                              lmax_per_tile=256, tile_chunk=4)
    jviews, tviews = _views(0, ["C01_a", "C01_b"])
    init = np.random.RandomState(3).normal(size=(2, cfg.model.embeddings_dim)).astype(np.float32)
    env = _sun_envmap()
    mask = np.ones((H, W), np.float32)
    mask[40:, :] = 0.0
    rec = _ArgmaxRecorder()
    jevaluation.np = rec
    jevaluation.render = jax.jit(jrenderer.render, static_argnums=(5,), static_argnames=(
        "envlight_sh_degree", "sky_sh_degree", "specular", "fix_sky", "debug"))
    try:
        j_emb = jevaluation.optimize_test_embeddings(params, s, JMLPNet(), jviews, cfg, jrcfg,
                                                     jnp.asarray(init), iters=3)
        j_relit = jevaluation.eval_view_with_gt_envmap(
            params, s, cfg, jrcfg, jviews[0], env, mask, init_rot=(-0.5, 0.2, 0.1),
            sun_angle_range=(0.0, np.pi), n_angles=3, threshold=0.9, scale=4.0)
        j_white = jevaluation.eval_white_light(params, s, cfg, jrcfg, jviews[1])
    finally:
        jevaluation.np = np
        jevaluation.render = jrenderer.render
    gp, gs = convert.gaussians_from_numpy({k: np.asarray(v) for k, v in p._asdict().items()},
                                          {k: np.asarray(v) for k, v in s._asdict().items()})
    tparams = {"gaussians": gp, "mlp": convert.mlp_state_dict_from_flax(mlp),
               "embeddings": torch.zeros(2, 32)}
    return dict(cfg=cfg, tparams=tparams, tstate=gs, rcfg=RasterizerConfig(W, H, max_dup=1 << 14),
                tviews=tviews, init=init, env=env, mask=mask, j_emb=np.asarray(j_emb),
                j_relit=j_relit, j_angle_psnrs=rec.inputs[0], j_white=j_white)


# ------------------------------------------------------------------ envmap


def test_envmap_functions_match_jax():
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(envmap.equirect_dirs(64), jenvmap.equirect_dirs(64))
    np.testing.assert_array_equal(envmap.solid_angle_map(64), jenvmap.solid_angle_map(64))
    np.testing.assert_array_equal(envmap.diffuse_band_coefficients(5),
                                  jenvmap.diffuse_band_coefficients(5))
    img = rng.uniform(0, 1.5, (32, 64, 3)).astype(np.float32)
    sat = envmap.saturate_envmap(img, 0.9, 10.0)
    np.testing.assert_array_equal(sat, jenvmap.saturate_envmap(img, 0.9, 10.0))
    coeffs = envmap.project_envmap_to_sh(sat, 4)
    np.testing.assert_allclose(coeffs, jenvmap.project_envmap_to_sh(sat, 4), rtol=0, atol=ATOL)
    for convolve in (True, False):
        np.testing.assert_allclose(envmap.render_sh_map(coeffs, 48, convolve),
                                   jenvmap.render_sh_map(coeffs, 48, convolve),
                                   rtol=0, atol=ATOL)
    np.testing.assert_array_equal(envmap.euler_zyx_matrix(0.3, -1.1, 2.0),
                                  jenvmap.euler_zyx_matrix(0.3, -1.1, 2.0))
    for yaw, pitch, roll in ((0.0, 1.3, 0.0), (0.4, -0.7, -np.pi / 2)):
        np.testing.assert_allclose(envmap.rotate_sh(coeffs, yaw, pitch, roll),
                                   jenvmap.rotate_sh(coeffs, yaw, pitch, roll), rtol=0, atol=ATOL)


def test_envmap_resize_matches_opencv():
    """Envmaps that are not 2:1, or wider than 1000 pixels, are resized before
    the projection; the port's bicubic resize stands in for OpenCV's."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(1).uniform(0, 1, (40, 120, 3)).astype(np.float32)
    np.testing.assert_allclose(envmap.resize_cubic(img, 120, 60),
                               cv2.resize(img, (120, 60), interpolation=cv2.INTER_CUBIC),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(envmap.project_envmap_to_sh(img, 4),
                               jenvmap.project_envmap_to_sh(img, 4), rtol=0, atol=ATOL)


# ------------------------------------------------------------------ evaluation


def test_optimize_test_embeddings_matches_jax(ref):
    emb = evaluation.optimize_test_embeddings(
        ref["tparams"], ref["tstate"], MLPNet(), ref["tviews"], ref["cfg"], ref["rcfg"],
        torch.as_tensor(ref["init"]), iters=3, device="cpu")
    assert float((emb - torch.as_tensor(ref["init"])).abs().max()) > 1e-4   # it moved
    np.testing.assert_allclose(emb.numpy(), ref["j_emb"], rtol=0, atol=EMB_ATOL)


def test_eval_view_with_gt_envmap_matches_jax(ref):
    res = evaluation.eval_view_with_gt_envmap(
        ref["tparams"], ref["tstate"], ref["cfg"], ref["rcfg"], ref["tviews"][0], ref["env"],
        ref["mask"], init_rot=(-0.5, 0.2, 0.1), sun_angle_range=(0.0, np.pi), n_angles=3,
        threshold=0.9, scale=4.0, device="cpu")
    want = ref["j_relit"]
    np.testing.assert_allclose(res.angle_psnrs, ref["j_angle_psnrs"], rtol=0, atol=1e-3)
    assert np.diff(np.sort(res.angle_psnrs)).min() > 0.01   # the angles light it apart
    assert res.best_angle == want.best_angle
    assert abs(res.psnr - want.psnr) < 1e-3
    np.testing.assert_allclose([res.mae, res.mse], [want.mae, want.mse], rtol=1e-4)
    assert_image_close(res.image, want.image)


def test_eval_white_light_matches_jax(ref):
    img = evaluation.eval_white_light(ref["tparams"], ref["tstate"], ref["cfg"], ref["rcfg"],
                                      ref["tviews"][1], device="cpu")
    assert img.shape == (H, W, 3) and img.max() > 0
    assert_image_close(img, ref["j_white"])


def test_evaluate_half_metrics_and_lpips_match_jax():
    rng = np.random.RandomState(2)
    ims = [rng.uniform(0, 1, (16, 32, 3)).astype(np.float32) for _ in range(2)]
    gts = [np.clip(im + rng.normal(0, 0.1, im.shape), 0, 1).astype(np.float32) for im in ims]
    w = synth_weights(seed=4)
    got = evaluation.evaluate_half_metrics(ims, gts, lambda a, b: lpips.lpips(a, b, w),
                                           device="cpu")
    jw = {k: jnp.asarray(v) for k, v in w.items()}   # arguments, not jit constants
    j_lpips = jax.jit(jlpips.lpips)
    want = jevaluation.evaluate_half_metrics(ims, gts, lambda a, b: j_lpips(a, b, jw))
    assert got.keys() == want.keys() == {"psnr", "ssim", "lpips"}
    for k in want:
        assert abs(got[k] - want[k]) < ATOL, (k, got[k], want[k])
    assert got["lpips"] > 0
    # [H, W, C] and [C, H, W] inputs alike; the weights' schema is checked.
    a, b = torch.as_tensor(ims[0]), torch.as_tensor(gts[0])
    assert float(lpips.lpips(a, b, w)) == float(lpips.lpips(a.movedim(-1, 0),
                                                            b.movedim(-1, 0), w))
    lpips.validate_weights(w)
    with pytest.raises(ValueError, match="shape"):
        lpips.validate_weights(dict(w, **{"lins.0.weight": np.zeros((1, 3, 1, 1))}))
    assert lpips.make_lpips_fn("/nonexistent/lpips.npz") is None


# ------------------------------------------------------------------ host helpers


def test_mask_resize_and_erosion_match_opencv():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    for (h, w), (dw, dh) in (((48, 64), (100, 75)), ((300, 400), (160, 120)),
                             ((100, 150), (64, 48)), ((128, 128), (64, 64)), ((37, 41), (13, 11)),
                             ((64, 64), (64, 64))):
        for img in (rng.randint(0, 256, (h, w)).astype(np.uint8),
                    ((rng.uniform(0, 1, (h, w)) > 0.4) * 255).astype(np.uint8)):
            np.testing.assert_array_equal(eval_gt_envmaps.resize_linear_u8(img, dw, dh),
                                          cv2.resize(img, (dw, dh)))
            np.testing.assert_array_equal(eval_gt_envmaps._erode(img),
                                          cv2.erode(img, np.ones((5, 5), np.uint8)))


def test_depth_colormap_matches_matplotlib():
    pytest.importorskip("matplotlib")
    depth = np.random.RandomState(0).uniform(1, 5, (40, 30)).astype(np.float32)
    depth[0, :3] = [0.0, 9.0, 3.0]
    np.testing.assert_array_equal(render_cli.depth_colormap(depth),
                                  jrender_cli.depth_colormap(depth))


# ------------------------------------------------------------------ CLI chain


def test_full_eval_cli_chain(tmp_path):
    """train -> render -> metrics --half -> GT-envmap evaluation on the CPU, on
    tests/test_trainer_e2e.py's dataset with view r_0 held out; then the other
    evaluation CLIs on the same checkpoint."""
    scene = "lk2"
    data_root = tmp_path / "data"
    src = data_root / scene
    make_dataset(str(src), n_views=4)
    meta = json.loads((src / "transforms_train.json").read_text())
    (src / "transforms_test.json").write_text(json.dumps(dict(meta, frames=meta["frames"][:1])))
    (src / "transforms_train.json").write_text(json.dumps(dict(meta, frames=meta["frames"][1:])))
    rng = np.random.RandomState(9)
    Image.fromarray((rng.uniform(0.2, 1.0, (32, 64, 3)) * 255).astype(np.uint8)).save(
        data_root / "env.png")
    mask = np.zeros((80, 80), np.uint8)
    mask[10:70, 5:75] = 255
    Image.fromarray(mask).save(data_root / "mask.png")
    tc = data_root / "test_configs" / scene
    tc.mkdir(parents=True)
    (tc / "test_config.json").write_text(json.dumps({"r_0.png": {
        "env_map_path": str(data_root / "env.png"), "mask_path": str(data_root / "mask.png"),
        "initial_env_map_rotation": {"x": -90, "y": 0, "z": 0}, "sun_angles": [0, 360],
        "env_map_scaling": {"threshold": 0.999, "scale": 10}}}))
    out = tmp_path / "out"
    full_eval.main([f"--data_root={data_root}", f"--output={out}", f"--scenes={scene}",
                    "--device=cpu", "optimizer.iterations=2", "runtime.pool_capacity=9000",
                    "runtime.max_dup=16384", "optimizer.optim_embeddings_test_iters=1"])
    mp = out / scene
    for split, names in (("train", ["r_1", "r_2", "r_3"]), ("test", ["r_0"])):
        d = mp / split / "iteration_2"
        for aov in render_cli.AOV_DIRS:
            ext = ".npy" if aov.startswith("rendered_") else ".png"
            assert {n + ext for n in names} <= set(os.listdir(d / aov)), aov
    results = json.loads((mp / "results.json").read_text())
    assert set(results) == {"train/iteration_2", "test/iteration_2"}
    for r in results.values():
        assert np.isfinite([r["psnr"], r["ssim"], r["mse"]]).all() and r["lpips"] is None
        assert r["lpips_reason"].startswith("weights unavailable")
    relit = mp / "relit_gt_envmaps" / "iteration_2"
    assert (relit / "r_0.png").exists()
    lines = (relit / "metrics.txt").read_text().splitlines()
    assert lines[0].startswith("r_0: PSNR") and np.isfinite(float(lines[-1].split()[-1]))
    logged = [json.loads(line) for line in open(mp / "train_log.jsonl")]
    assert any("test_psnr_halffit" in r for r in logged)

    common = [f"dataset.source_path={src}", f"dataset.model_path={mp}", "dataset.eval=true",
              "runtime.pool_capacity=9000", "runtime.max_dup=16384", "model.load_iteration=2",
              f"dataset.test_config_path={tc}", "--device=cpu"]
    white = eval_white_light.main(common)
    assert set(white) == {"r_0"} and np.isfinite(white["r_0"]["psnr"])
    eval_gt_envmaps_all.main(common + ["--random_sun"])
    every = json.loads((mp / "relit_gt_envmaps_all" / "iteration_2" / "results.json").read_text())
    assert eval_gt_envmaps_all.lighting_condition_of("r_0_00000000") == "r_0"
    assert set(every) == {"r_0", "mean"} and np.isfinite(every["mean"]["psnr"])
    frames = relit_novel_view.main(common + [f"--envmap={data_root / 'env.png'}", "--steps=2"])
    assert {"frame_000.png", "frame_001.png"} <= set(os.listdir(frames))
    process_gt_envmaps.main([f"--input={data_root}", f"--output={tmp_path / 'sh'}", "--deg=2"])
    coeffs = np.loadtxt(tmp_path / "sh" / "env_sh.txt")
    assert coeffs.shape == (9, 3) and np.isfinite(coeffs).all()
    assert (tmp_path / "sh" / "mask_recon.png").exists()
