"""Offline LPIPS weight converter: writes the npz that `models/lpips.py` loads.

Port of the JAX package's `scripts/convert_lpips_weights.py`. Run it once on a
machine with network access and `torch`, `torchvision` and the `lpips`
package (the conversion downloads VGG16's ImageNet weights), then copy the
file into the repository:

    python -m relightable3dgaussians_w_torch.scripts.convert_lpips_weights \\
        [--out=relightable3dgaussians_w_torch/models/_lpips_vgg16.npz]
    python -m relightable3dgaussians_w_torch.scripts.convert_lpips_weights --print-schema

The file is written next to its destination under a temporary name, checked
against `models.lpips.EXPECTED_SCHEMA` (`validate_weights`, as the loader
checks it) and only then renamed, so a failed run leaves no partial npz.
`--print-schema` needs neither package. Without them the conversion raises the
ImportError that names the missing one.
"""

from __future__ import annotations

import argparse
import hashlib
import os
from pathlib import Path

import numpy as np

from ..models import lpips

DEFAULT_OUT = Path(lpips.DEFAULT_WEIGHTS)


def convert(out: Path) -> str:
    """Convert, validate and move into place. Returns the file's sha256."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp.npz")
    try:
        lpips.convert_torch_weights(str(tmp))
        with np.load(tmp) as z:
            w = dict(z)
        lpips.validate_weights(w)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return hashlib.sha256(out.read_bytes()).hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--print-schema", action="store_true",
                    help="print the expected npz schema and exit")
    args = ap.parse_args(argv)
    if args.print_schema:
        for k, shape in lpips.EXPECTED_SCHEMA.items():
            print(f"{k}: float32 {shape}")
        return 0
    digest = convert(Path(args.out))
    print(f"wrote {args.out} ({len(lpips.EXPECTED_SCHEMA)} arrays, schema ok)")
    print(f"sha256: {digest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
