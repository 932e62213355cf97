"""Training observability: JSONL metrics, optional TensorBoard, profiler window.

Port of the JAX package's `utils/logging.py`. The always-on sink is a JSONL
file; TensorBoard (`torch.utils.tensorboard`) mirrors scalars, histograms and
images when asked for, and asking for it where it does not import raises. A
`torch.profiler` trace (CPU and, on the card, CUDA activity) covers a step
window ("START:END"), written as a Chrome trace.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


class TrainLogger:
    """JSONL + optional TensorBoard scalar/histogram/image logger."""

    def __init__(self, jsonl_path: str, tb_dir: str | None = None):
        self.jsonl_path = jsonl_path
        self.tb = None
        if tb_dir is not None:
            from torch.utils.tensorboard import SummaryWriter  # raises where absent

            self.tb = SummaryWriter(tb_dir)

    def scalars(self, step: int, values: dict):
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(dict(iter=step, **values)) + "\n")
        if self.tb is not None:
            for k, v in values.items():
                if isinstance(v, (int, float)):
                    self.tb.add_scalar(f"train_patches/{k}", v, step)

    def histogram(self, step: int, name: str, values):
        if self.tb is not None:
            self.tb.add_histogram(f"scene/{name}_histogram", np.asarray(values), step)

    def image(self, step: int, name: str, hwc):
        """hwc: [H, W, C] float image in [0, 1]."""
        if self.tb is not None:
            img = np.clip(np.asarray(hwc), 0.0, 1.0)
            self.tb.add_image(name, img.transpose(2, 0, 1), step)

    def close(self):
        if self.tb is not None:
            self.tb.flush()
            self.tb.close()


class ProfilerWindow:
    """Start/stop a torch.profiler trace over a step window ("START:END")."""

    def __init__(self, spec: str, out_dir: str):
        self.start_step = self.end_step = -1
        self.out_dir = out_dir
        self._prof = None
        if spec:
            a, b = spec.split(":")
            self.start_step, self.end_step = int(a), int(b)

    def step(self, it: int):
        if it == self.start_step and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        if it == self.end_step and self._prof is not None:
            self._stop()
            print(f"profiler trace for steps [{self.start_step}, {self.end_step}) "
                  f"written to {self.out_dir}")

    def _stop(self):
        self._prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(
            self.out_dir, f"steps_{self.start_step}_{self.end_step}.json"))
        self._prof = None

    def close(self):
        if self._prof is not None:
            self._stop()

