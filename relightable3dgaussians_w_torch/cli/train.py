"""Training CLI: the reference's `train.py` driver for the port.

Usage:
    python -m relightable3dgaussians_w_torch.cli.train dataset.source_path=/data/lk2 \\
        dataset.model_path=./output/lk2 [--config=run.yaml] [key=value ...] \\
        [--device=cpu] [--dist-backend=gloo|nccl]

The `key=value` overrides and the YAML file are the JAX package's config tree
(`config.py`). Training runs on the CUDA card unless `--device=cpu` asks for the
CPU (plain PyTorch versions of the kernels); without a card it raises.

On a NeRF-OSR-layout dataset, `model.init_embeddings=true` initializes the
per-image embeddings from an autoencoder pretrained on `train/rgb`
(`optimizer.embednet_pretrain_epochs` epochs, draws seeded with runtime.seed +
1), and `model.init_sh_mlp=true` fits the illumination MLP to the SH priors in
`train/envmaps_init/*.npy` (seed runtime.seed + 2), before training starts.
Only the parameters are replaced; Adam's moments and step stay as built.
`model.load_iteration=N` (-1 = the latest) resumes training from that
checkpoint of dataset.model_path (with its step and Adam moments when the
full-state bundle is there).

Several devices: runtime.data_parallel x runtime.gauss_shards ranks, one
process per device, all running this command. Launch them with `torchrun
--nproc-per-node=N -m relightable3dgaussians_w_torch.cli.train ...`, or start
each with runtime.coordinator_address=host:port runtime.num_processes=N
runtime.process_id=r. The process group uses NCCL on the card and gloo with
--device=cpu; `--dist-backend=` names another.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import load_config


def main(argv=None):
    """Parse `argv`, train, and return the trainer."""
    argv = argv if argv is not None else sys.argv[1:]
    yaml_path, device, backend = None, "cuda", None
    overrides = []
    for a in argv:
        if a.startswith("--config="):
            yaml_path = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--dist-backend="):
            backend = a.split("=", 1)[1]
        elif a.startswith("--"):
            raise ValueError(f"unknown option {a}")
        else:
            overrides.append(a)
    cfg = load_config(overrides, yaml_path)

    from ..device import resolve_device
    from ..parallel import multihost
    from ..pretrain import initialize_embeddings_from_dataset, initialize_sh_mlp
    from ..trainer import Relightable3DGWTrainer

    # The process group first: a no-op unless the config or the launcher's
    # environment asks for more than one process.
    multihost.maybe_initialize(cfg.runtime, resolve_device(device), backend)
    trainer = Relightable3DGWTrainer(cfg, device=device, dist_backend=backend)
    dev = trainer.device

    if cfg.model.init_embeddings:
        gen = torch.Generator(device=dev).manual_seed(cfg.runtime.seed + 1)
        emb, _ = initialize_embeddings_from_dataset(
            gen, cfg.dataset.source_path, cfg.model.embeddings_dim,
            cfg.optimizer.embednet_pretrain_epochs)
        trainer.state = trainer.state._replace(
            params=dict(trainer.state.params, embeddings=emb))
    if cfg.model.init_sh_mlp:
        prior_dir = f"{cfg.dataset.source_path}/train/envmaps_init"
        priors = {f: np.load(f"{prior_dir}/{f}") for f in sorted(os.listdir(prior_dir))
                  if f.endswith(".npy")}
        names = [c.image_name for c in trainer.train_cameras]
        gen = torch.Generator(device=dev).manual_seed(cfg.runtime.seed + 2)
        mlp_params = initialize_sh_mlp(gen, trainer.mlp, trainer.state.params["mlp"],
                                       trainer.state.params["embeddings"], names, priors)
        trainer.state = trainer.state._replace(
            params=dict(trainer.state.params, mlp=mlp_params))

    if cfg.model.load_iteration:
        trainer.load_checkpoint(cfg.model.load_iteration)
        step = int(trainer.state.step)
        trainer.logger.scalars(0, dict(event="resume", load_iteration=cfg.model.load_iteration,
                                       step=step))
        print(f"resumed from {cfg.dataset.model_path} at step {step}")

    trainer.train()
    print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
