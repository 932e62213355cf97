"""relightable3dgaussians_w_torch — the PyTorch/CUDA port of relightable3dgaussians_w_tpu.

The JAX package beside this one is the reference: every module here mirrors its
counterpart's name and layout, and the tests in `tests/test_torch_*.py` feed the
same numpy inputs to both. This package imports torch and numpy only.

Layout:
  ops/        rasterizer: preprocess (+ row intervals), binning, compositing,
              knn; ops/cuda/ holds the build helper and the wrappers of the
              hand-written Hopper kernels
  csrc/       CUDA C++ sources of those kernels (built with nvcc at first use)
  models/     Gaussian pool (getters, density control), SH environment light,
              FG LUT, illumination MLP
  data/       cameras, scene readers (NeRF-OSR, COLMAP, Blender), PLY, COLMAP
  utils/      SH math, camera/graphics math, losses, logging, general helpers
  renderer.py the render passes (render_rgb, the fused AOV render)
  train_step.py one training step, densify, opacity reset, pool growth
  trainer.py  the trainer (schedule, overflow healing, probe, checkpoints)
  cli/train.py the training command line
  checkpoint.py checkpoint formats shared with the JAX trainer
  native.py   the C++ host library (COLMAP parsing, exact 3-NN), built with g++
  viewer.py   the network viewer (SIBR and json wire protocols)
  convert.py  carries JAX weights (as numpy) across to this package
  synthetic.py the seeded synthetic scene and camera

Entry points run on the card by default (`device="cuda"`) and raise when CUDA is
absent; pass `device="cpu"` for the plain PyTorch path.
"""

__version__ = "0.1.0"
