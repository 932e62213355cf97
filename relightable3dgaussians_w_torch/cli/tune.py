"""Hyperparameter tuning over the relit3DGS-W regularization weights: port of
the JAX package's `cli/tune.py` (the reference's tune_hyperparameters.py:21-107:
Optuna TPE over lambda_sky_gauss / lambda_envlight / reg_normal_from_iter /
embeddings_dim, with the mean train PSNR as the objective).

Uses Optuna when it can import it; otherwise a log-uniform random search from
`np.random.RandomState(0)` that appends each trial to `<output>/trials.jsonl`.

Usage:
    python -m relightable3dgaussians_w_torch.cli.tune --scenes=<path>[,<path>...] \\
        [--trials=20] [--iterations=7000] [--output=./output/tune] [--device=cpu]

Each trial trains every scene on the CUDA card unless `--device=cpu` asks for
the CPU; without a card it raises.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


SEARCH_SPACE = {
    "optimizer.lambda_sky_gauss": ("log", 1e-3, 1.0),
    "optimizer.lambda_envlight": ("log", 1.0, 1000.0),
    "optimizer.reg_normal_from_iter": ("int", 5_000, 25_000),
    "model.embeddings_dim": ("choice", [16, 32, 64]),
}


def sample_params(rng):
    out = {}
    for key, spec in SEARCH_SPACE.items():
        if spec[0] == "log":
            out[key] = float(np.exp(rng.uniform(np.log(spec[1]), np.log(spec[2]))))
        elif spec[0] == "int":
            out[key] = int(rng.randint(spec[1], spec[2] + 1))
        else:
            out[key] = spec[1][rng.randint(len(spec[1]))]
    return out


def objective(scene_paths: list[str], overrides: dict, iterations: int, out_root: str,
              device: str = "cuda") -> float:
    """Mean over the scenes of the train PSNR that the trainer's final
    evaluation report logs (`train_psnr`: up to 5 train views, each under its
    own embedding)."""
    from ..config import load_config
    from ..trainer import Relightable3DGWTrainer

    psnrs = []
    for sp in scene_paths:
        ovs = [f"{k}={v}" for k, v in overrides.items()]
        ovs += [f"dataset.source_path={sp}",
                f"dataset.model_path={os.path.join(out_root, os.path.basename(sp))}"]
        cfg = load_config(ovs)
        cfg.optimizer.iterations = iterations
        trainer = Relightable3DGWTrainer(cfg, device=device)
        trainer.train(iterations=iterations, save_iterations=())
        with open(trainer.log_path) as f:
            # The JAX package reads "psnr" from the log's last line, which the
            # final report writes without that key (KeyError).
            reports = [r for r in map(json.loads, f) if "train_psnr" in r]
        psnrs.append(reports[-1]["train_psnr"])
    return float(np.mean(psnrs))


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    kwargs = {a.split("=", 1)[0].lstrip("-"): a.split("=", 1)[1] for a in argv if "=" in a}
    scenes = kwargs["scenes"].split(",")
    n_trials = int(kwargs.get("trials", 20))
    iterations = int(kwargs.get("iterations", 7000))
    out_root = kwargs.get("output", "./output/tune")
    device = kwargs.get("device", "cuda")
    os.makedirs(out_root, exist_ok=True)
    store = os.path.join(out_root, "trials.jsonl")

    try:
        import optuna  # noqa: F401

        have_optuna = True
    except ImportError:
        have_optuna = False

    if have_optuna:
        import optuna

        def opt_objective(trial):
            params = {
                "optimizer.lambda_sky_gauss": trial.suggest_float(
                    "lambda_sky_gauss", 1e-3, 1.0, log=True),
                "optimizer.lambda_envlight": trial.suggest_float(
                    "lambda_envlight", 1.0, 1000.0, log=True),
                "optimizer.reg_normal_from_iter": trial.suggest_int(
                    "reg_normal_from_iter", 5000, 25000),
                "model.embeddings_dim": trial.suggest_categorical("embeddings_dim", [16, 32, 64]),
            }
            return objective(scenes, params, iterations, out_root, device)

        study = optuna.create_study(direction="maximize",
                                    storage=f"sqlite:///{out_root}/study.db",
                                    load_if_exists=True, study_name="relit3dgw")
        study.optimize(opt_objective, n_trials=n_trials)
        print("best:", study.best_params, study.best_value)
        return

    rng = np.random.RandomState(0)
    best = (-np.inf, None)
    for t in range(n_trials):
        params = sample_params(rng)
        score = objective(scenes, params, iterations, out_root, device)
        with open(store, "a") as f:
            f.write(json.dumps({"trial": t, "params": params, "psnr": score}) + "\n")
        if score > best[0]:
            best = (score, params)
        print(f"trial {t}: psnr {score:.3f} (best {best[0]:.3f})")
    print("best:", best)


if __name__ == "__main__":
    main()
