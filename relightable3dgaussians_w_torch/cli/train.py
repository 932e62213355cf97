"""Training CLI: the reference's `train.py` driver for the port.

Usage:
    python -m relightable3dgaussians_w_torch.cli.train dataset.source_path=/data/lk2 \\
        dataset.model_path=./output/lk2 [--config=run.yaml] [key=value ...] \\
        [--device=cpu]

The `key=value` overrides and the YAML file are the JAX package's config tree
(`config.py`). Training runs on the CUDA card unless `--device=cpu` asks for the
CPU (plain PyTorch versions of the kernels); without a card it raises.
"""

from __future__ import annotations

import sys

from ..config import load_config


def main(argv=None):
    """Parse `argv`, train, and return the trainer."""
    argv = argv if argv is not None else sys.argv[1:]
    yaml_path, device = None, "cuda"
    overrides = []
    for a in argv:
        if a.startswith("--config="):
            yaml_path = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--"):
            raise ValueError(f"unknown option {a}")
        else:
            overrides.append(a)
    cfg = load_config(overrides, yaml_path)

    from ..trainer import Relightable3DGWTrainer

    trainer = Relightable3DGWTrainer(cfg, device=device)
    trainer.train()
    print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
