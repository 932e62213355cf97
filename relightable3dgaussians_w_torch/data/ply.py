"""Minimal PLY reader/writer (binary little-endian + ascii), numpy only.

A copy of the JAX package's `data/ply.py` (jax-free). The checkpoint PLY is the
interop surface with the reference format and with the JAX trainer.
"""

from __future__ import annotations

import numpy as np

_PLY2NP = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the 'vertex' element into {property_name: array}."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = None
        count = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in ply header")
            tokens = line.strip().split()
            if not tokens:
                continue
            key = tokens[0].decode()
            if key == "format":
                fmt = tokens[1].decode()
            elif key == "element":
                in_vertex = tokens[1] == b"vertex"
                if in_vertex:
                    count = int(tokens[2])
            elif key == "property" and in_vertex:
                if tokens[1] == b"list":
                    raise ValueError("list properties unsupported for vertex element")
                props.append((tokens[2].decode(), _PLY2NP[tokens[1].decode()]))
            elif key == "end_header":
                break
        if fmt == "binary_little_endian":
            dtype = np.dtype([(n, "<" + t) for n, t in props])
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        elif fmt == "binary_big_endian":
            dtype = np.dtype([(n, ">" + t) for n, t in props])
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        elif fmt == "ascii":
            dtype = np.dtype([(n, t) for n, t in props])
            raw = np.loadtxt(f, dtype=np.float64, max_rows=count).reshape(count, len(props))
            data = np.rec.fromarrays(
                [raw[:, i].astype(dtype[i]) for i in range(len(props))], dtype=dtype
            )
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return {n: np.ascontiguousarray(data[n]) for n, _ in props}


def write_ply(path: str, fields: dict[str, np.ndarray]):
    """Write a 'vertex' element, float32, binary little-endian."""
    names = list(fields)
    n = len(next(iter(fields.values())))
    dtype = np.dtype([(name, "<f4") for name in names])
    rec = np.empty(n, dtype=dtype)
    for name in names:
        arr = np.asarray(fields[name]).reshape(n)
        rec[name] = arr.astype(np.float32)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += [f"property float {name}" for name in names]
        header += ["end_header", ""]
        f.write("\n".join(header).encode())
        f.write(rec.tobytes())
