"""Rasterizer: preprocess -> binning -> compositing (ops/rasterize.py); the
hand-written CUDA kernels' wrappers live in ops/cuda/."""
