"""Full pipeline per scene: train -> render -> metrics (right halves) -> GT-envmap
evaluation.

Port of the JAX package's `cli/full_eval.py` (the reference's `full_eval.py`,
scenes lk2, lwp and st in turn). The evaluated checkpoint is the last training
iteration: 40,000, or the `optimizer.iterations=` override. The GT-envmap step
runs when <data_root>/test_configs/<scene> exists.

Usage:
    python -m relightable3dgaussians_w_torch.cli.full_eval --data_root=/data/nerfosr \\
        --output=./output [--scenes=lk2,lwp,st] [--device=cpu] [key=value overrides]
"""

from __future__ import annotations

import os
import sys

DEFAULT_SCENES = ("lk2", "lwp", "st")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    kwargs = {a.split("=", 1)[0][2:]: a.split("=", 1)[1] for a in argv if a.startswith("--")}
    overrides = [a for a in argv if not a.startswith("--")]
    data_root = kwargs["data_root"]
    output = kwargs.get("output", "./output")
    scenes = kwargs.get("scenes", ",".join(DEFAULT_SCENES)).split(",")
    device = [f"--device={kwargs.get('device', 'cuda')}"]

    from . import train as train_cli
    from . import render as render_cli
    from . import metrics as metrics_cli
    from . import eval_gt_envmaps as eval_cli

    iters = next((o.split("=", 1)[1] for o in overrides
                  if o.startswith("optimizer.iterations=")), "40000")

    for scene in scenes:
        src = os.path.join(data_root, scene)
        mp = os.path.join(output, scene)
        common = [f"dataset.source_path={src}", f"dataset.model_path={mp}",
                  "dataset.eval=true"] + overrides
        print(f"=== scene {scene}: train ===")
        train_cli.main(common + device)
        print(f"=== scene {scene}: render ===")
        render_cli.main(common + [f"model.load_iteration={iters}"] + device)
        print(f"=== scene {scene}: metrics ===")
        metrics_cli.main([mp, "--half"] + device)
        tc = os.path.join(data_root, "test_configs", scene)
        if os.path.isdir(tc):
            print(f"=== scene {scene}: gt-envmap eval ===")
            eval_cli.main(common + [f"dataset.test_config_path={tc}",
                                    f"model.load_iteration={iters}"] + device)


if __name__ == "__main__":
    main()
