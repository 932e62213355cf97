"""Wrappers of the port's hand-written CUDA kernels (sources in `csrc/`).

Each wrapper launches its kernel for a CUDA tensor and counts the launch in its
module's `launches`; for a CPU tensor it calls the kernel's plain PyTorch
version, which lives beside the code it replaces (`ops/binning.py`,
`ops/composite.py`). A build or launch failure raises: there is no fallback.
"""
