"""The port's view store (`data/view_store.py`) on a tiny in-the-wild
collection: a dozen photos in three sizes (landscape 4:3 and 3:2, portrait
3:4), JPEG and PNG, each with its own PINHOLE camera, a sky mask and an
occluder mask in the NeRF-OSR layout.

The store's canvases equal the JAX package's `trainer.pad_cameras` canvases
of the same files bit for bit; two training steps fed from the store leave
the state two steps fed the float32 canvases leave; the store holds at most 5
bytes a photo pixel and no float32 copy; the plain version of kernel V
equals its formula at odd sizes and at the canvas's edge.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from relightable3dgaussians_w_tpu.data.readers import read_nerfosr_info as j_read_nerfosr
from relightable3dgaussians_w_tpu.trainer import pad_cameras as j_pad_cameras

from relightable3dgaussians_w_torch import config, train_step as TS, trainer
from relightable3dgaussians_w_torch.data.ply import write_ply
from relightable3dgaussians_w_torch.data.readers import read_nerfosr_info
from relightable3dgaussians_w_torch.data.view_store import ViewStore, unpack_view_plain
from relightable3dgaussians_w_torch.ops.cuda.view_unpack import unpack_view

import _torch_threads

_torch_threads.share_cores()

SIZES = [(40, 30), (40, 27), (30, 40)]   # (W, H): 4:3, 3:2, 3:4 portrait


def make_collection(root, n=12):
    """The collection on disk; photo i is JPEG when i is even, else PNG."""
    rng = np.random.RandomState(3)
    for d in ("sparse/0", "images", "sky_masks", "masks", "train/rgb"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    cams, imgs = [], []
    for i in range(n):
        W, H = SIZES[i % 3]
        fov = np.radians(rng.uniform(50, 70))
        f = W / (2 * np.tan(fov / 2))
        cams.append(f"{i + 1} PINHOLE {W} {H} {f:.17g} {f:.17g} {W / 2} {H / 2}")
        a = 0.05 * (i - n / 2)
        t = [0.0, 0.0, 4.0 + 0.1 * i]
        imgs += [f"{i + 1} {np.cos(a / 2):.17g} 0 {np.sin(a / 2):.17g} 0 {t[0]} {t[1]} {t[2]} {i + 1} "
                 f"v{i:02d}.{'jpg' if i % 2 == 0 else 'png'}", ""]
        yy, xx = np.mgrid[0:H, 0:W]
        photo = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        Image.fromarray(photo).save(os.path.join(root, "images", imgs[-2].split()[-1]),
                                    quality=95)
        horizon = H * (0.25 + 0.15 * rng.rand()) + 2 * np.sin(xx / 5.0)
        sky = np.where(yy < horizon, 0, 255).astype(np.uint8)
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        occ = np.where(((xx - cx) / 6) ** 2 + ((yy - cy) / 4) ** 2 < 1, 0, 255).astype(np.uint8)
        Image.fromarray(sky).save(os.path.join(root, "sky_masks", f"v{i:02d}_mask.png"))
        Image.fromarray(occ).save(os.path.join(root, "masks", f"v{i:02d}.png"))
        open(os.path.join(root, "train/rgb", f"v{i:02d}.png"), "w").close()
    with open(os.path.join(root, "sparse/0/cameras.txt"), "w") as f:
        f.write("\n".join(cams) + "\n")
    with open(os.path.join(root, "sparse/0/images.txt"), "w") as f:
        f.write("\n".join(imgs) + "\n")
    pts = rng.uniform(-0.1, 0.1, (300, 3))   # a small cloud: a few hundred sky points
    z = np.zeros(300)
    write_ply(os.path.join(root, "sparse/0/points3D.ply"),
              {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2], "nx": z, "ny": z, "nz": z,
               "red": z + 128, "green": z + 128, "blue": z + 128})


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("collection"))
    make_collection(root)
    return root


def test_store_canvases_equal_the_jax_packages_padding(collection):
    cams = read_nerfosr_info(collection, None, False).train_cameras
    want, H, W = j_pad_cameras(j_read_nerfosr(collection, None, False).train_cameras)
    assert (H, W) == (40, 40) and len(want) == 12
    store = ViewStore(cams, H, W, "cpu")
    assert {(c.width, c.height) for c in cams} == set(SIZES)
    for i, v in enumerate(want):
        assert 0.0 < v["sky_mask"].mean() < 1.0 and 0.0 < v["occluders_mask"].mean() < 1.0
        got = [t.numpy() for t in store.fetch(i)]
        for g, k in zip(got, ("image", "sky_mask", "occluders_mask")):
            assert g.dtype == np.float32 and np.array_equal(g, v[k]), (i, k)
        # the port's own padding of the same camera, and a view of its own
        port, _, _ = trainer.pad_cameras([cams[i]])
        assert all(np.array_equal(port[0][k], v[k][:port[0][k].shape[0], :port[0][k].shape[1]])
                   for k in ("image", "sky_mask", "occluders_mask"))
        assert np.array_equal(store[i]["image"], v["image"])
    s = store.stats()
    assert s["fetches"] == 12 and s["fetch_canvas_pixels"] == 12 * H * W
    assert s["fetch_photo_pixels"] == s["pixels"] == sum(c.width * c.height for c in cams)


def test_two_steps_from_the_store_equal_two_from_float_canvases(collection, tmp_path):
    cfg = config.Config()
    cfg.dataset.source_path, cfg.dataset.model_path = collection, str(tmp_path / "out")
    cfg.runtime.pool_capacity = 1024
    cfg.runtime.max_dup = 1 << 14
    tr = trainer.Relightable3DGWTrainer(cfg, device="cpu")
    assert isinstance(tr.train_views, trainer.ViewStore) and (tr.H, tr.W) == (40, 40)
    padded, _, _ = trainer.pad_cameras(tr.train_cameras)
    states = []
    for from_store in (True, False):
        gen = torch.Generator().manual_seed(5)
        state = tr.state
        for i in (4, 9):      # a portrait photo, a landscape one
            if from_store:
                image, sky, occ = tr.train_views.fetch(i)
            else:
                image, sky, occ = (torch.as_tensor(padded[i][k]) for k in
                                   ("image", "sky_mask", "occluders_mask"))
            draws = TS.make_draws(gen, tr.mlp, cfg)
            state, aux = TS.train_step(state, tr.train_views.mats[i], image, sky, occ,
                                       tr.train_cameras[i].uid, draws, tr.bg_color, tr.mlp, cfg,
                                       tr.rcfg, device=tr.device)
            assert int(aux.overflow) == 0
        states.append(TS.tree_map(lambda x: x, state))
    leaves = lambda s: [x for x in torch.utils._pytree.tree_leaves(s) if torch.is_tensor(x)]
    a, b = leaves(states[0]), leaves(states[1])
    assert len(a) == len(b) > 10
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(states[0].params["gaussians"].xyz, tr.state.params["gaussians"].xyz)


def test_store_holds_bytes_and_no_float_copy(collection):
    cams = read_nerfosr_info(collection, None, False).train_cameras
    assert all(c.__dict__[k] is None for c in cams
               for k in ("image", "sky_mask", "occluders_mask"))
    store = ViewStore(cams, 40, 40, "cpu")
    pixels = sum(c.width * c.height for c in cams)
    assert store.buffer.dtype == torch.uint8 and store.stats()["device_bytes"] == 5 * pixels
    held = [t for t in vars(store).values() if torch.is_tensor(t)]
    assert held == [store.buffer]
    assert all(c.__dict__["image"] is None for c in store.cams)
    store.fetch(0)
    assert [t.dtype for t in store._slots[0]] == [torch.float32] * 3   # one canvas a slot


def _formula(rgb, sky, occ, background, H, W):
    """The canvas by the readers' numpy arithmetic and `pad_cameras`."""
    f = rgb.astype(np.float32) / 255.0
    if background is not None:
        f = f[..., :3] * f[..., 3:4] + background * (1 - f[..., 3:4])
    h, w = rgb.shape[:2]
    out = [np.zeros((H, W, 3), np.float32), np.zeros((H, W), np.float32),
           np.zeros((H, W), np.float32)]
    out[0][:h, :w] = f
    out[1][:h, :w] = 1.0 if sky is None else sky.astype(np.float32) / 255.0
    out[2][:h, :w] = 1.0 if occ is None else occ.astype(np.float32) / 255.0
    return out


@pytest.mark.parametrize("h, w, H, W, channels, masks", [
    (1, 1, 1, 1, 3, True), (7, 5, 7, 5, 3, True), (5, 3, 9, 11, 3, False),
    (13, 17, 13, 21, 4, False), (9, 6, 11, 6, 4, True)])
def test_plain_unpack_equals_the_formula(h, w, H, W, channels, masks):
    rng = np.random.RandomState(h * 100 + w)
    rgb = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
    rgb[0, 0] = 0
    rgb[-1, -1] = 255      # both ends of the byte range, at the photo's corners
    sky = rng.randint(0, 256, (h, w)).astype(np.uint8) if masks else None
    occ = rng.randint(0, 256, (h, w)).astype(np.uint8) if masks else None
    bg = 1.0 if channels == 4 else None
    out = tuple(torch.full(s, 7.0) for s in ((H, W, 3), (H, W), (H, W)))
    t = lambda a: None if a is None else torch.as_tensor(a)
    got = unpack_view(t(rgb), t(sky), t(occ), bg, out)
    want = _formula(rgb, sky, occ, bg, H, W)
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), x)
    again = unpack_view_plain(t(rgb), t(sky), t(occ), bg,
                              tuple(torch.empty_like(o) for o in out))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
