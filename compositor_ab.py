"""Two builds of the port's kernel sources on one card, in turns, on chip_smoke's inputs.

    python3 compositor_ab.py [OLD_COMPOSITOR] [--old-expand=OLD] [--old-segment-sum=OLD]
                             [--old-flags="--fmad=false"] [--out DIR]

Each OLD is another version of one source in `relightable3dgaussians_w_torch/csrc/`
(for example `git show <commit>:<that path> > build/ab/old.cu`): OLD_COMPOSITOR
of `tile_composite.cu` (kernels B, B' and C), `--old-expand` of `expand.cu`
(kernels A and A-int; same C interface), `--old-segment-sum` of `segment_sum.cu` (kernel D
as PRs 2-5 built it: `r3dgw_segment_sum` over an int64 sort permutation, which
its wrapper got from sorting the ids). `--old-flags` are the extra nvcc flags
the old compositor was built with. The script

1. compiles both versions of each given source to cubins with `-Xptxas -v` and
   prints, per kernel, its registers and spills and its static count of
   instructions and of LDS, STS and SHFL, over the whole kernel and, for the
   compositor, over its per-entry loop with that loop's opcode histogram (from
   `cuobjdump -sass`, where the toolkit has it; the SASS goes to
   `DIR/<source>_{new,old}.sass`), then builds each old source as a shared
   library with `ops/cuda/build.py`'s flags;
2. runs `chip_smoke.main()` with its holders wrapped, so that on every input
   set chip_smoke holds a kernel on, both builds run on the same inputs in
   turns (new, old, old, new; each turn the median of 20 launches timed with
   CUDA events) and the old build's output is compared with the new one's:
   B (`hold_forward`: the serving frame at C = 3, the training step's and the
   trainer's C = 13, the evaluation's 21 and 51), B' (the first frame of
   `serve_packed_phase`), C and D (`hold_step_kernels`: the training step and
   the trainer) and A and A-int (`hold_expansion`: rects on the serving frame
   and the training step, row intervals on the intervals phase's two scenes,
   the trainer and the bench's aniso-8 call). D's new side is the gather's route, the binning's
   permutation kernel P plus the segment sum, with beside it the kernel
   alone, P alone, what P replaces in the binning (PR 5's gather gid[perm]
   and a scatter of the inverse permutation, P's plain version) and the
   general route (sort + kernel); its old side is PR 5's wrapper (sort,
   search, kernel). A, A-int and D are timed by the device time of what
   they launch (chip_smoke's `device_ms`), and again with CUDA events.

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
from relightable3dgaussians_w_torch.ops import binning
from relightable3dgaussians_w_torch.ops.cuda import build
from relightable3dgaussians_w_torch.ops.cuda import expand as ek
from relightable3dgaussians_w_torch.ops.cuda import segment_sum as sk
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
    every nvcc started at once; a label is "<kernel source name>_{new,old}"."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for label, (src, extra) in sources.items():
        for kind, args in (("so", build.COMMON_FLAGS), ("cubin", ["-std=c++17", "-O3", "-cubin",
                                                                   "-Xptxas", "-v"])):
            if kind == "so" and label.endswith("_new"):
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
    sass = sass_counts(built["cubin"], log.parent / f"{label}.sass") or {}
    names = demangle(sorted(set(info) | set(sass)))
    for mangled, name in names.items():
        report({"what": "kernel", "build": label, "kernel": name,
                **info.get(mangled, {}),
                "sass_static": sass.get(mangled, "not measured")}, log)


@contextlib.contextmanager
def use(lib, module=ck):
    """Route a wrapper module's launches to `lib` (a loaded build) inside the block."""
    saved = module._lib
    module._lib = lambda: lib
    try:
        yield
    finally:
        module._lib = saved


def under(ctx, fn):
    """fn, called inside a fresh `ctx()` each time."""
    def call():
        with ctx():
            return fn()
    return call


def turns(fn, libs, old_fn=None, extra=None, timer=cs.median_ms):
    """ms of each side, in turns new, old, old, new: `fn` with each build of the
    compositor (`libs`), or `fn` against `old_fn`; `extra` ({name: fn}) are
    timed once each after the turns. `timer`: chip_smoke's `median_ms` (CUDA
    events around each call) or `device_ms` (the card's kernel time)."""
    sides = {"new": fn, "old": old_fn or under(lambda: use(libs["old"]), fn)}
    t = {"new": [], "old": []}
    for who in ("new", "old", "old", "new"):
        t[who].append(timer(sides[who], ITERS))
    return {"timer": timer.__name__, "new_ms": float(np.mean(t["new"])),
            "old_ms": float(np.mean(t["old"])), "new_turns_ms": t["new"],
            "old_turns_ms": t["old"],
            **{f"{k}_ms": timer(f, ITERS) for k, f in (extra or {}).items()}}


def forward_diff(fn, libs):
    with use(libs["old"]):
        old = fn()
    new = fn()
    torch.cuda.synchronize()
    return {"rgb_max_abs_diff": float((new[0] - old[0]).abs().max()),
            "tfin_max_abs_diff": float((new[1] - old[1]).abs().max()),
            "bitwise_equal": bool(torch.equal(new[0], old[0]) and torch.equal(new[1], old[1]))}


def old_segment_sum_rows(lib, rows, ids, n):
    """Kernel D as PRs 2-5 called it: a stable sort of the ids, each Gaussian's
    range by binary search, then the old kernel over the int64 permutation."""
    sorted_ids, perm = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(sorted_ids,
                                torch.arange(n + 1, dtype=ids.dtype, device=ids.device))
    out = torch.empty((n, rows.shape[1]), dtype=torch.float32, device=rows.device)
    err = lib.r3dgw_segment_sum(rows.data_ptr(), rows.shape[1], perm.data_ptr(),
                                bounds.data_ptr(), n, out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "old segment_sum launch")
    return out


def bind_old_segment_sum(lib):
    lib.r3dgw_error_string.argtypes = [ctypes.c_int]
    lib.r3dgw_error_string.restype = ctypes.c_char_p
    lib.r3dgw_segment_sum.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_void_p]
    lib.r3dgw_segment_sum.restype = ctypes.c_int
    return lib


def ab_segment_sum(x, old_lib, card, log, label):
    """D on one step's inputs: the gather's route (the binning's permutation
    kernel P, then the segment sum) against PR 5's wrapper, in turns, and their
    outputs compared."""
    d_rows, ids, n, bounds, order = (x[k] for k in ("d_rows", "ids", "n", "bounds", "order"))
    sort = cs.binning_sort(bounds, order)
    new_fn = lambda: sk.segment_sum_ordered(d_rows, bounds, sk.permute_entries(*sort)[1])
    old_fn = lambda: old_segment_sum_rows(old_lib, d_rows, ids, n)
    new, old = new_fn(), old_fn()
    torch.cuda.synchronize()
    report({"what": "D", "inputs": label, "features": d_rows.shape[1], "entries": x["entries"],
            "rows": n, "slots": d_rows.shape[0],
            **turns(new_fn, None, old_fn, extra={
                "new_kernel": lambda: sk.segment_sum_ordered(d_rows, bounds, order),
                "new_permute_entries": lambda: sk.permute_entries(*sort),
                "pr5_gather": lambda: sort[0][sort[1]],
                "plain_permute": lambda: binning.permute_entries_plain(*sort[:2]),
                "new_general_route": lambda: sk.segment_sum_rows(d_rows, ids, n)},
                timer=cs.device_ms),
            "event_timed": turns(new_fn, None, old_fn),
            "max_abs_diff": float((new - old).abs().max()),
            "bitwise_equal": bool(torch.equal(new, old)), "card": card}, log)


def install_hooks(libs, card, log):
    """Wrap chip_smoke's holders so that every input set they hold a kernel of a
    compared source on is also timed and compared with both builds."""
    hold_forward, hold_step, serve_packed = cs.hold_forward, cs.hold_step_kernels, \
        cs.serve_packed_phase
    hold_expansion = cs.hold_expansion
    # hold_step_kernels's inputs, in the order chip_smoke holds them.
    step_labels = iter(("bench train call", "training step", "trainer's trained state"))

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
        label = next(step_labels, "step")
        if "segment_sum" in libs:
            ab_segment_sum(x, libs["segment_sum"], card, log, label)
        if "tile_composite" not in libs:
            return out
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
        report({"what": "C", "inputs": label, "channels": x["feat"].shape[1] - 6,
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

    def ab_expansion(call, label):
        out = hold_expansion(call, label)
        args, kwargs = call
        fn = lambda: ek.expand_entries(*args, **kwargs)
        old = under(lambda: use(libs["expand"], ek), fn)()
        new = fn()
        torch.cuda.synchronize()
        report({"what": "A" if kwargs.get("packed") is None else "A-int", "inputs": label,
                "gaussians": args[0].shape[0], "entries": out[1]["entries"],
                "max_dup": args[-1], "bound_ms": out[0]["bound_ms"],
                **turns(fn, None, under(lambda: use(libs["expand"], ek), fn),
                        timer=cs.device_ms),
                "event_timed": turns(fn, None, under(lambda: use(libs["expand"], ek), fn)),
                "bitwise_equal": bool(torch.equal(new[0], old[0])
                                      and torch.equal(new[1], old[1])), "card": card}, log)
        return out

    cs.hold_step_kernels = ab_step
    if "tile_composite" in libs:
        cs.hold_forward, cs.serve_packed_phase = ab_forward, ab_packed
    if "expand" in libs:
        cs.hold_expansion = ab_expansion


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_source", type=Path, nargs="?", help="old tile_composite.cu")
    ap.add_argument("--old-expand", type=Path, help="old expand.cu")
    ap.add_argument("--old-segment-sum", type=Path, help="old segment_sum.cu")
    ap.add_argument("--old-flags", default="", help="extra nvcc flags of the old compositor")
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
    olds = {name: (path, shlex.split(a.old_flags) if name == "tile_composite" else [])
            for name, path in (("tile_composite", a.old_source), ("expand", a.old_expand),
                               ("segment_sum", a.old_segment_sum)) if path is not None}
    if not olds:
        ap.error("give at least one old source")
    sources = {}
    for name, old in olds.items():
        src, extra = build.KERNELS[name]
        sources.update({f"{name}_new": (build.SRC_DIR / src, extra), f"{name}_old": old})
    built = compile_all(sources)
    for label in sources:
        kernel_table(label, built[label], log)
    bind = {"tile_composite": ck.bind, "expand": ek.bind, "segment_sum": bind_old_segment_sum}
    libs = {name: bind[name](ctypes.CDLL(str(built[f"{name}_old"]["so"]))) for name in olds}
    if "tile_composite" in libs:
        libs.update(new=ck._lib(), old=libs["tile_composite"])
    install_hooks(libs, card, log)
    rc = cs.main()
    print(card, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
