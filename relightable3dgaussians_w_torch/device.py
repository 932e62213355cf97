"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; when it is absent
    this raises instead of falling back, so a CPU run is always asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path")
    return dev


def card_line(device: str | torch.device = "cuda") -> str | None:
    """The card's name and power limit as nvidia-smi prints them ("NVIDIA H100
    80GB HBM3, 700.00 W"): a card may be set below its top power and then runs
    slower, so every time measured on it carries this line. None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    return smi.stdout.strip().splitlines()[0]
