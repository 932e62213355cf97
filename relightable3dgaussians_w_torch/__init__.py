"""relightable3dgaussians_w_torch — the PyTorch/CUDA port of relightable3dgaussians_w_tpu.

The JAX package beside this one is the reference: every module here mirrors its
counterpart's name and layout, and the tests in `tests/test_torch_*.py` feed the
same numpy inputs to both. This package imports torch and numpy only.

Layout:
  ops/        rasterizer: preprocess, binning, compositing; ops/cuda/ holds the
              build helper and the wrappers of the hand-written Hopper kernels
  csrc/       CUDA C++ sources of those kernels (built with nvcc at first use)
  models/     Gaussian pool getters, SH environment light, FG LUT, illumination MLP
  utils/      SH math, camera/graphics math, general helpers
  renderer.py the serving render pass (render_rgb)
  viewer.py   the network viewer (SIBR and json wire protocols)
  convert.py  carries JAX weights (as numpy) across to this package
  synthetic.py the seeded synthetic scene and camera

Entry points run on the card by default (`device="cuda"`) and raise when CUDA is
absent; pass `device="cpu"` for the plain PyTorch path.
"""

__version__ = "0.1.0"
