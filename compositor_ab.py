"""Two builds of the compositor source on one card, in turns, on chip_smoke's inputs.

    python3 compositor_ab.py OLD_SOURCE [--old-flags="--fmad=false"] [--out DIR]

OLD_SOURCE is another version of `relightable3dgaussians_w_torch/csrc/tile_composite.cu`
with the same C interface (for example `git show <commit>:<that path> > build/ab/old.cu`);
`--old-flags` are the extra nvcc flags that version was built with. The script

1. compiles both sources to cubins with `-Xptxas -v` and prints, per kernel, its
   registers and spills and its static count of LDS, STS and SHFL instructions,
   over the whole kernel and over its per-entry loop with that loop's opcode
   histogram (from `cuobjdump -sass`, where the toolkit has it; the SASS goes
   to `DIR/compositor_ab_{new,old}.sass`), then builds OLD_SOURCE as a shared
   library with `ops/cuda/build.py`'s flags plus `--old-flags`;
2. runs `chip_smoke.main()` with its compositor holders wrapped: wherever
   chip_smoke holds kernel B against its plain version (`hold_forward`: the
   serving frame at C = 3, the training step's and the trainer's C = 13, the
   evaluation's 21 and 51), B' (the first frame of `serve_packed_phase`) or C
   (`hold_step_kernels`: the training step and the trainer), both builds run on
   the same inputs in turns (new, old, old, new; each turn the median of 20
   launches timed with CUDA events), and the old build's output is compared with
   the new one's.

Each comparison is printed as a JSON line starting with "ab " and written to
`DIR/compositor_ab.jsonl` (DIR: `--out`, by default `build/compositor_ab/`).
Needs one card and nvcc; exits non-zero without them or when chip_smoke
fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from relightable3dgaussians_w_torch.ops.cuda import build
from relightable3dgaussians_w_torch.ops.cuda import tile_composite as ck

OUT_DIR = build.BUILD_DIR.parent / "compositor_ab"
ITERS = 20
GROUPS = (("mean2d", slice(0, 2)), ("conic", slice(2, 5)), ("opacity", slice(5, 6)),
          ("colors", slice(6, None)))


def report(obj, log):
    line = json.dumps(obj)
    print("ab " + line, flush=True)
    with open(log, "a") as f:
        f.write(line + "\n")


def compile_all(sources):
    """{label: (source, extra flags)} -> {label: (shared library, cubin, nvcc log)},
    every nvcc started at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for label, (src, extra) in sources.items():
        for kind, args in (("so", build.COMMON_FLAGS), ("cubin", ["-std=c++17", "-O3", "-cubin",
                                                                   "-Xptxas", "-v"])):
            if kind == "so" and label == "new":
                continue   # the new library is build.py's own
            out = OUT_DIR / f"{label}.{kind}"
            cmd = [build._nvcc(), *build.ARCH_FLAGS, *args, *extra, "-o", str(out), str(src)]
            jobs.append((label, kind, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    got = {label: {} for label in sources}
    for label, kind, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label} ({kind}):\n{log}")
        got[label][kind] = out
        if kind == "cubin":
            got[label]["log"] = log
    return got


def demangle(names):
    tool = shutil.which("cu++filt") or str(Path(build._nvcc()).parent / "cu++filt")
    tool = tool if Path(tool).exists() else shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    out = res.stdout.splitlines()
    return dict(zip(names, out)) if res.returncode == 0 and len(out) == len(names) else \
        {n: n for n in names}


def ptxas_info(log):
    """{kernel: {registers, spill_stores, spill_loads}} from `-Xptxas -v` output."""
    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            info[cur] = {}
        elif cur and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            info[cur].update(spill_stores=int(st), spill_loads=int(ld))
        elif cur and "registers" in line:
            info[cur]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return info


PIPE_OPS = ("LDS", "STS", "SHFL")
INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def inner_loop(instrs):
    """The kernel's per-entry loop: the innermost backward branch around the
    first MUFU.EX2 (the `expf` of every visited pair), as (first, last) indices
    into `instrs`, or None."""
    addr = {a: i for i, (a, _, _) in enumerate(instrs)}
    ex2 = next((i for i, (_, op, _) in enumerate(instrs) if op.startswith("MUFU.EX2")), None)
    best = None
    for i, (_, op, args) in enumerate(instrs):
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        j = addr.get(int(m.group(1), 16)) if m else None
        if ex2 is not None and j is not None and j <= ex2 <= i and (
                best is None or i - j < best[1] - best[0]):
            best = (j, i)
    return best


def sass_counts(cubin, dump):
    """{kernel: static counts}: over each kernel's whole SASS (instructions,
    LDS, STS, SHFL) and over its per-entry loop (`inner_loop`: the same and an
    opcode histogram); None where the toolkit has no cuobjdump. The SASS text
    goes to `dump`."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    res = subprocess.run([str(tool), "-sass", str(cubin)], capture_output=True, text=True)
    if res.returncode != 0:
        return None
    dump.write_text(res.stdout)
    kernels, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernels.setdefault(m.group(1), [])
            continue
        m = INSTR.match(line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    counts = {}
    for name, instrs in kernels.items():
        base = lambda ops: {"instructions": len(ops), **{k: sum(o.split(".")[0] == k for o in ops)
                                                          for k in PIPE_OPS}}
        ops = [op for _, op, _ in instrs]
        counts[name] = {"kernel": base(ops)}
        loop = inner_loop(instrs)
        if loop:
            body = ops[loop[0]:loop[1] + 1]
            hist = {}
            for op in body:
                hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
            counts[name]["inner_loop"] = {**base(body), "opcodes": dict(
                sorted(hist.items(), key=lambda kv: -kv[1]))}
    return counts


def kernel_table(label, built, log):
    info = ptxas_info(built["log"])
    sass = sass_counts(built["cubin"], log.parent / f"compositor_ab_{label}.sass") or {}
    names = demangle(sorted(set(info) | set(sass)))
    for mangled, name in names.items():
        report({"what": "kernel", "build": label, "kernel": name,
                **info.get(mangled, {}),
                "sass_static": sass.get(mangled, "not measured")}, log)


def load_old(path):
    return ck.bind(ctypes.CDLL(str(path)))


@contextlib.contextmanager
def use(lib):
    """Route the compositor wrappers to `lib` (a loaded build) inside the block."""
    saved = ck._lib
    ck._lib = lambda: lib
    try:
        yield
    finally:
        ck._lib = saved


def turns(fn, libs):
    """Median CUDA-event ms of `fn` with each build, in turns new, old, old, new."""
    t = {"new": [], "old": []}
    for who in ("new", "old", "old", "new"):
        with use(libs[who]):
            t[who].append(cs.median_ms(fn, ITERS))
    return {"new_ms": float(np.mean(t["new"])), "old_ms": float(np.mean(t["old"])),
            "new_turns_ms": t["new"], "old_turns_ms": t["old"]}


def forward_diff(fn, libs):
    with use(libs["old"]):
        old = fn()
    new = fn()
    torch.cuda.synchronize()
    return {"rgb_max_abs_diff": float((new[0] - old[0]).abs().max()),
            "tfin_max_abs_diff": float((new[1] - old[1]).abs().max()),
            "bitwise_equal": bool(torch.equal(new[0], old[0]) and torch.equal(new[1], old[1]))}


def install_hooks(libs, card, log):
    """Wrap chip_smoke's compositor holders so that every input set they hold a
    kernel on is also timed and compared with both builds."""
    hold_forward, hold_step, serve_packed = cs.hold_forward, cs.hold_step_kernels, \
        cs.serve_packed_phase
    step_labels = iter(("training step", "trainer's trained state"))

    def ab_forward(call, label):
        out = hold_forward(call, label)
        feat, ts, te, bg, gx, gy = call
        fn = lambda: ck.composite_forward(feat, ts, te, bg, gx, gy)
        report({"what": "B", "inputs": label, "channels": feat.shape[1] - 6,
                "entries": int((te - ts).sum()), "bound_ms": out[0]["bound_ms"],
                **turns(fn, libs), **forward_diff(fn, libs), "card": card}, log)
        return out

    def ab_step(x, rcfg, dev):
        out = hold_step(x, rcfg, dev)
        args = tuple(x[k] for k in ("feat", "tile_start", "tile_end", "bg", "rgb", "tfin",
                                    "g_rgb", "g_tfin")) + (rcfg.grid_x, rcfg.grid_y)
        fn = lambda: ck.composite_backward(*args)
        new = fn()[0]
        with use(libs["old"]):
            old = fn()[0]
        torch.cuda.synchronize()
        rel = {name: float((new[:, c] - old[:, c]).abs().max() / old[:, c].abs().max())
               for name, c in GROUPS}
        c_row = next(r for r in out[0] if r["name"] == "composite_backward")
        report({"what": "C", "inputs": next(step_labels), "channels": x["feat"].shape[1] - 6,
                "entries": x["entries"], "bound_ms": c_row["bound_ms"], **turns(fn, libs),
                "max_rel_diff_by_group": rel,
                "zero_rows_equal": bool(torch.equal((new == 0).all(1), (old == 0).all(1))),
                "card": card}, log)
        return out

    last_packed = {}
    packed_fn = ck.composite_forward_packed

    def record_packed(*args, **kwargs):
        last_packed.update(args=args, kwargs=kwargs)
        return packed_fn(*args, **kwargs)

    def ab_packed(*args, **kwargs):
        ck.composite_forward_packed = record_packed
        try:
            out = serve_packed(*args, **kwargs)
        finally:
            ck.composite_forward_packed = packed_fn
        a, kw = last_packed["args"], last_packed["kwargs"]   # the first frame's B' inputs
        fn = lambda: packed_fn(*a, **kw)
        report({"what": "B'", "inputs": "serving frame, yaw -10", "entries": int((a[2] - a[1]).sum()),
                "bound_ms": out[1]["bound_ms"], **turns(fn, libs), **forward_diff(fn, libs),
                "card": card}, log)
        return out

    cs.hold_forward, cs.hold_step_kernels, cs.serve_packed_phase = ab_forward, ab_step, ab_packed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_source", type=Path)
    ap.add_argument("--old-flags", default="", help="extra nvcc flags of the old build")
    ap.add_argument("--out", type=Path, default=OUT_DIR, help="directory of the JSON lines and SASS")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("compositor_ab: no CUDA device", file=sys.stderr)
        return 1
    a.out.mkdir(parents=True, exist_ok=True)
    log = a.out / "compositor_ab.jsonl"
    log.write_text("")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    src, extra = build.KERNELS["tile_composite"]
    built = compile_all({"new": (build.SRC_DIR / src, extra),
                         "old": (a.old_source, shlex.split(a.old_flags))})
    for label in ("new", "old"):
        kernel_table(label, built[label], log)
    libs = {"new": ck._lib(), "old": load_old(built["old"]["so"])}
    install_hooks(libs, card, log)
    rc = cs.main()
    print(card, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
