"""COLMAP reconstruction wrappers: port of the JAX package's `cli/convert.py`.

The reference's `convert.py` (the standard 3DGS pipeline: feature_extractor ->
exhaustive_matcher -> mapper -> image_undistorter) and `convert_nerfosr.py`
(NeRF-OSR-tuned SIFT parameters, convert_nerfosr.py:34-44), with the same
`colmap` command lines as the JAX package. They shell out to the `colmap` CLI,
so run them wherever COLMAP is installed; the outputs (sparse/0 + undistorted
images) are what data/readers.py reads.

Usage:
    python -m relightable3dgaussians_w_torch.cli.convert --source_path=<scene> \
        [--camera=OPENCV] [--nerfosr] [--no_gpu]
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys


def run(cmd: list[str]):
    print("+", " ".join(cmd))
    res = subprocess.run(cmd)
    if res.returncode != 0:
        raise SystemExit(f"command failed ({res.returncode}): {' '.join(cmd)}")


def convert(source_path: str, camera: str = "OPENCV", nerfosr: bool = False,
            no_gpu: bool = False, resize: bool = False):
    if shutil.which("colmap") is None:
        raise SystemExit("colmap CLI not found on PATH — install COLMAP to run conversion")
    use_gpu = "0" if no_gpu else "1"
    db = os.path.join(source_path, "distorted/database.db")
    os.makedirs(os.path.dirname(db), exist_ok=True)

    feat = [
        "colmap", "feature_extractor",
        "--database_path", db,
        "--image_path", os.path.join(source_path, "input"),
        "--ImageReader.single_camera", "1",
        "--ImageReader.camera_model", camera,
        "--SiftExtraction.use_gpu", use_gpu,
    ]
    if nerfosr:
        # NeRF-OSR-tuned SIFT params (reference convert_nerfosr.py:34-44).
        feat += [
            "--SiftExtraction.peak_threshold", "0.002",
            "--SiftExtraction.edge_threshold", "16",
            "--SiftExtraction.max_num_features", "16384",
            "--SiftExtraction.estimate_affine_shape", "1",
            "--SiftExtraction.domain_size_pooling", "1",
        ]
    run(feat)
    match = ["colmap", "exhaustive_matcher", "--database_path", db,
             "--SiftMatching.use_gpu", use_gpu]
    if nerfosr:
        match += ["--SiftMatching.guided_matching", "1"]
    run(match)
    sparse = os.path.join(source_path, "distorted/sparse")
    os.makedirs(sparse, exist_ok=True)
    run(["colmap", "mapper", "--database_path", db,
         "--image_path", os.path.join(source_path, "input"),
         "--output_path", sparse, "--Mapper.ba_global_function_tolerance", "0.000001"])
    run(["colmap", "image_undistorter",
         "--image_path", os.path.join(source_path, "input"),
         "--input_path", os.path.join(sparse, "0"),
         "--output_path", source_path, "--output_type", "COLMAP"])
    # 3DGS layout: move sparse files into sparse/0.
    s = os.path.join(source_path, "sparse")
    os.makedirs(os.path.join(s, "0"), exist_ok=True)
    for f in os.listdir(s):
        if f != "0":
            shutil.move(os.path.join(s, f), os.path.join(s, "0", f))


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    kwargs = {a.split("=", 1)[0].lstrip("-"): (a.split("=", 1)[1] if "=" in a else True)
              for a in argv}
    convert(
        source_path=kwargs["source_path"],
        camera=kwargs.get("camera", "OPENCV"),
        nerfosr=bool(kwargs.get("nerfosr", False)),
        no_gpu=bool(kwargs.get("no_gpu", False)),
    )


if __name__ == "__main__":
    main()
