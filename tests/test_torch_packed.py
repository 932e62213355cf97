"""The torch port's packed-RGB serving mode (kernel B' and its plain version)
against the JAX package, on the CPU.

The JAX side runs its Pallas packed kernel in interpret mode, as
tests/test_packed_rgb.py does; the port takes its plain version (CPU tensors).
Packing must equal JAX's bitwise; the packed render is held to the JAX
package's kernel tolerance (under 0.1% of pixels off by more than 1e-3,
median error under 1e-5) against JAX's, bitwise to the port's exact path fed
the dequantized colors, and within the quantization half-step 8/4095/2 + 1e-6
of the exact render (G exact to 1e-6). One JAX render per module.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relightable3dgaussians_w_tpu.ops.pallas import tile_composite as jtile_composite
from relightable3dgaussians_w_tpu.ops.rasterize import rasterize as jrasterize

from relightable3dgaussians_w_torch import convert, synthetic, viewer
from relightable3dgaussians_w_torch.config import Config
from relightable3dgaussians_w_torch.models.nets import MLPNet
from relightable3dgaussians_w_torch.ops import composite, rasterize
from relightable3dgaussians_w_torch.ops.cuda import tile_composite as composite_kernel

from test_rasterize import make_scene
from test_torch_ops import assert_image_close, to_t, torch_cam, torch_rcfg
import _torch_threads

_torch_threads.share_cores()

NAMES = ("means3d", "scales", "quats", "opacities", "colors", "bg")
HALF_STEP = 8.0 / 4095.0 / 2 + 1e-6


@pytest.fixture(scope="module")
def scene():
    """A 300-Gaussian 64x64 scene with HDR colors, and JAX's packed Pallas render."""
    arrs, cam, cfg, _ = make_scene(n=300, seed=1)
    colors = np.asarray(arrs["colors"]) * 1.6 - 0.1   # some under 0, some over 1
    arrs = dict(arrs, colors=jnp.asarray(colors, jnp.float32))
    cfg_p = cfg._replace(use_pallas=True, pallas_interpret=True, pallas_chunk=128,
                         packed_rgb=True)
    j_img, j_aux = jax.jit(lambda a, c: jrasterize(**a, cam=c, cfg=cfg_p))(arrs, cam)
    args = [to_t(arrs[k]) for k in NAMES]
    return dict(args=args, cam=torch_cam(cam), rcfg=torch_rcfg(cfg), colors=colors,
                j_img=np.asarray(j_img), j_alpha=np.asarray(j_aux.alpha))


def _render(scene, packed, colors=None):
    a = list(scene["args"])
    if colors is not None:
        a[4] = colors
    return rasterize.rasterize(*a, scene["cam"], scene["rcfg"]._replace(packed_rgb=packed),
                               device="cpu")


def test_pack_rb_matches_jax():
    assert np.float32(composite.PACK_STEP).tobytes() == np.float32(8.0 / 4095.0).tobytes()
    rng = np.random.RandomState(0)
    c = rng.uniform(-1.0, 10.0, (4000, 3)).astype(np.float32)
    c[:8] = [[0, 0, 0], [8, 8, 8], [8.5, -1, 12], [1e-4, 0.5, 7.9999], [0.5 / 511.875] * 3,
             [1.5 / 511.875] * 3, [2.5 / 511.875] * 3, [4095.5 / 511.875] * 3]
    rb, g = composite.pack_rb(to_t(c))
    j_rb, j_g = jtile_composite.pack_rb(jnp.asarray(c))
    np.testing.assert_array_equal(rb.numpy(), np.asarray(j_rb))
    np.testing.assert_array_equal(g.numpy(), np.asarray(j_g))
    # The unpack equals the JAX kernel's dequantization (R, G, B rows).
    j_rows = jtile_composite._unpack_rb_rows(j_rb[None], j_g[None])
    np.testing.assert_array_equal(composite.unpack_rb(rb, g).numpy(), np.asarray(j_rows).T)


def test_packed_render_matches_jax_pallas(scene):
    img, aux = _render(scene, packed=True)
    assert int(aux.overflow) == 0
    assert_image_close(img.numpy(), scene["j_img"])
    assert_image_close(aux.alpha.numpy(), scene["j_alpha"])


def test_packed_equals_exact_on_dequantized_colors(scene):
    img, aux = _render(scene, packed=True)
    deq = composite.unpack_rb(*composite.pack_rb(scene["args"][4]))
    ref, ref_aux = _render(scene, packed=False, colors=deq)
    assert torch.equal(img, ref)
    assert torch.equal(aux.alpha, ref_aux.alpha)


def test_packed_error_bound_vs_exact():
    """On colors inside [0, 8] the packed render is within the quantization
    half-step of the exact one, and G is exact."""
    arrs, cam, cfg, _ = make_scene(n=300, seed=1)
    args = [to_t(arrs[k]) for k in NAMES]
    exact, _ = rasterize.rasterize(*args, torch_cam(cam), torch_rcfg(cfg), device="cpu")
    packed, _ = rasterize.rasterize(*args, torch_cam(cam),
                                    torch_rcfg(cfg)._replace(packed_rgb=True), device="cpu")
    err = (packed - exact).abs()
    assert float(err.max()) <= HALF_STEP
    assert float(err[..., 1].max()) <= 1e-6


def test_packed_hdr_clamp_and_range():
    c = torch.tensor([[0.0, -0.5, 12.0], [composite.PACK_LIM, 1.0, composite.PACK_LIM - 1e-4]])
    deq = composite.unpack_rb(*composite.pack_rb(c))
    assert deq[0, 0] == 0.0 and deq[0, 2] == composite.PACK_LIM   # clamped at the top
    assert abs(float(deq[1, 2]) - (composite.PACK_LIM - 1e-4)) <= HALF_STEP
    assert deq[0, 1] == -0.5   # G passes through untouched


def test_packed_refuses_other_channel_counts_and_gradients(scene):
    a = list(scene["args"])
    rcfg = scene["rcfg"]._replace(packed_rgb=True)
    for C in (1, 4, 13):
        with pytest.raises(ValueError, match="3 color channels"):
            rasterize.rasterize(*a[:4], torch.ones(a[4].shape[0], C), torch.zeros(C),
                                scene["cam"], rcfg, device="cpu")
    colors = a[4].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="forward-only"):
        rasterize.rasterize(*a[:4], colors, a[5], scene["cam"], rcfg, device="cpu")
    feat = torch.zeros((4, 8), requires_grad=True)
    ts = torch.zeros(16, dtype=torch.int64)
    with pytest.raises(ValueError, match="forward-only"):
        composite_kernel.composite_forward_packed(feat, ts, ts, torch.zeros(3), 4, 4)
    with torch.no_grad():   # without a gradient to refuse, the rows render
        composite_kernel.composite_forward_packed(feat, ts, ts, torch.zeros(3), 4, 4)


class _Capture:
    def send_image(self, image):
        self.image = image


def test_packed_viewer_frame():
    """A viewer frame with runtime.serve_packed_rgb: every byte within 1 of the
    exact frame's (the quantization error is under a quarter of a byte step)."""
    W = H = 64
    p, s = synthetic.synthetic_scene(n=300, n_sky=40)
    host = type("Host", (), {})()
    host.W, host.H, host.mlp = W, H, MLPNet(generator=torch.Generator().manual_seed(0))
    host.bg_color = torch.zeros(3)
    host.rcfg = rasterize.RasterizerConfig(width=W, height=H, max_dup=1 << 13)
    host.state = viewer.ServeState(p, s, convert.embeddings_from_numpy(
        np.random.RandomState(0).normal(size=(2, 32)).astype(np.float32)))
    fov = 2 * float(np.arctan(np.tan(np.deg2rad(30.0))))
    req = {"viewmat": np.eye(4).tolist(), "fovx": fov, "fovy": fov, "width": W, "height": H,
           "embedding_index": 1}
    frames = []
    for packed in (False, True):
        host.cfg = Config()
        host.cfg.runtime.serve_packed_rgb = packed
        cap = _Capture()
        cap.device = torch.device("cpu")
        viewer._serve_frame(cap, host, req)
        assert int(cap.last_aux.overflow) == 0
        frames.append(cap.image.astype(int))
    exact, packed = frames
    assert exact.shape == (H, W, 3) and exact.max() > 0
    assert np.abs(packed - exact).max() <= 1
