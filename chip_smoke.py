"""Smoke run of the torch port's serving path, training step, trainer, evaluation,
pretraining, library and parallel modules, the training self-check, the
serving demo, the measurement scripts and the scaling harness on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `relightable3dgaussians_w_torch/csrc/`,
builds the full-size synthetic scene (1,000,000 Gaussians + 10,000 sky
Gaussians, random MLP weights from a seed), then:

1. device:  the card (nvidia-smi name and power limit), torch/CUDA versions
            and the kernels' build time;
2. kernels: on the first frame's inputs, each kernel against its plain PyTorch
            version (expansion bitwise; compositor within the image tolerance:
            under 0.1% of pixels off by more than 1e-3, median error under
            1e-5), with median times over repeated launches (CUDA events
            around each call; for the short expansion and segment-sum
            kernels the device time of their kernels from torch.profiler,
            which leaves out the wrapper's host time, with the event time
            beside it) and each kernel's lower bound from the bytes and
            float32 operations this frame needs (H100 SXM: 3.35 TB/s, 67
            TFLOP/s float32; the compositor's operations counted per (pixel,
            entry) pair the walk visits: the full cost where the entry
            contributes, the power test, or the power and alpha tests, where
            it is skipped; its bytes: the entry rows a tile visits before
            its last pixel terminates, not every entry of the tile);
3. stages:  the frame's stages timed one by one with CUDA events;
4. serve:   frames through the port's ViewerServer (json protocol on
            127.0.0.1) sweeping yaw over -10..10 degrees, each checked for its
            byte count, a zero entry overflow and launches of both kernels;
5. reference: a 2,000-Gaussian 64x64 render on the card against the plain
            PyTorch path on the CPU;
6. train_kernels: on the first training step's inputs (13 fused channels,
            taken from the autograd graph of `train_step.forward_loss`: the
            compositor's saved inputs and outputs, the cotangents that reach
            the compositor and the gather, and the gather's segment layout),
            the rect expansion the step's binning makes (bitwise), the
            compositor forward at C = 13, the compositor backward and the
            gather transpose (segment sum) against their plain versions (the
            backward per gradient group within max |delta| / max |ref| < 5e-3
            and zero on exactly the entry rows the plain version leaves zero,
            the segment sum within 1e-5 of index_add_ on both of its routes:
            the binning's layout, timed with the binning's permutation kernel
            P that builds it, and the general entry that sorts the ids; P
            bitwise), all bitwise equal over two launches, with times and
            bounds as in phase 2;
7. train:   6 training steps through `train_step` at full width (target: the
            port's own render of the scene under embedding 1; sky and occluder
            masks all ones), each checked for a finite loss, zero overflow,
            finite parameters, a nonzero densification statistic on visible
            rows and launches of all five kernels; ms per step (median of steps
            2-6), the peak device memory, and from a profiled window of 3 more
            steps the stage breakdown (the port's own profiler ranges) and the
            device idle share; then, from the starting state, 6 steps that all
            reuse one set of draws, whose loss must fall;
8. intervals: row-interval binning at yaw 0 on the scene as is and with
            scales[:, 0] *= 8: rect and interval entry counts, the
            row-interval kernel (I) and the interval expansion kernel (A-int)
            against their plain versions (bitwise, every row and slot) with
            times and bounds, and a render plus one backward with intervals on
            and off, which must give the same bits (image, alpha, the five
            gradients);
9. trainer: a COLMAP dataset of 8 views of the scene (yaw -10..10 degrees on
            an orbit, the port's renders, the 1,000,000 foreground points as
            the point cloud), trained through `cli.train.main` with the
            defaults plus runtime.row_intervals=true for 60 iterations (densify
            rounds of both variants, opacity resets, evaluation and save at
            the end): every step's loss finite, every binning overflow healed
            with only its own step rejected, launches of I, A-int, B, C, P and
            D, a densify round that selects, the checkpoint in the reference
            layout; then on the trained state (pool headroom 8) and view 0,
            kernels I and A-int (bitwise), B, C, P and D against their plain
            versions on the inputs the trainer's step gives them, the
            full-state and PLY reloads rendering view 0 as the trained state
            does, and steps with row intervals on (kernel I, then the eager
            plain pass in its place), and off (times and profiled stages); init,
            per-iteration (CUDA events between the loop's steps, no pull of
            its own) and event times;
10. serve_packed: the serve phase's sweep with runtime.serve_packed_rgb=true:
            each frame checked for its byte count, a zero entry overflow,
            launches of the packed compositor B' and none of B, and every byte
            within 1 of the exact frame at the same camera; on the first
            frame's inputs B' against its plain version (image tolerance) and
            bitwise against B fed the dequantized colors, with times and
            bounds; served ms per frame beside the exact mode's;
11. eval:   the trainer phase's dataset with dataset.eval=true (view 0 held
            out), a 256x512 equirect envmap with a sun and a 1000x1000
            evaluation mask from np.random.RandomState, through
            `cli.full_eval.main` (train EVAL_ITERS iterations with the defaults
            and a demand-sized budget; render train and test sets at 21
            channels with a 100-step test-embedding fit; metrics --half; the
            51-angle GT-envmap sweep), then `cli.eval_white_light.main` and
            `cli.relit_novel_view.main --steps=RELIT_STEPS` on its checkpoint:
            every artifact present, every metric finite, no entry overflow in
            any render after training, launches of B at 13, 21 and 51
            channels and of C, P and D; B at C = 21 (the first render) and C =
            51 (the sweep's first group) against its plain version with times
            and bounds; wall seconds of each stage.
12. pretrain: a NeRF-OSR-layout dataset of 32 views on the orbit (yaw
            -10..10 degrees, written after the trainer phase), alternating
            between two lighting conditions named in both of the forms
            `pretrain.lighting_condition_of` reads, each rendered under its
            own embedding, with train/envmaps_init/<condition>.npy the envlight
            SH of that embedding, through `cli.train.main` with
            model.init_embeddings=true model.init_sh_mlp=true: the embedding
            autoencoder at full width (256x256 inputs, channels_f 128, latent
            32, batch 32), the unit-norm encoding, the SH-MLP fit (MLP
            256/256/128, SH degrees 4 / 1) and trainer iterations: the last
            epoch's MSE below the first's, embeddings [32, 32] within 1e-5 of
            unit norm, every view's condition matching exactly one prior (not
            the empty prefix), the SH-MLP's MSE against its priors lower after
            the fit, every step's loss finite, launches of A or A-int, P, B at
            C = 13, C and D; wall seconds of each stage and the peak device
            memory; then one EmbeddingNet forward and backward (batch 4, 256^2)
            on the card against the CPU (`embedding_net_check`);
13. library: `knn_dist2_morton` on the 1,000,000 foreground points against
            the host's exact 3-NN (times, the median approx / exact ratio, the
            share within 2x; finite and positive) and against the CPU on a
            100,000-point subset (1e-6 relative); `pbr_bsdf` on 1.01M points,
            card against CPU (1e-5 relative, roughness in [0.5, 1]), with
            times; a seeded 256x512 sky (`smooth_sky`) written as Radiance .hdr, loaded
            into a cubemap and prefiltered by `build_mips` at res 512 on the
            card (timed), card against CPU at res 64 (1e-5 relative); and
            `shade_cubemap` of 1.01M points (timed);
14. parallel: (a) after the train phase, tile-parallel rendering on cuda:0
            in this process with 2 and 5 bands of tile rows (grid_y = 50): image,
            alpha and radii bitwise equal to the single-device `rasterize` at
            C = 3 (the served frame) and C = 13 (the training step's leaf
            inputs), the gradients of means, colors, opacities and the mean2d
            probe within 5e-3 (each band's entry budget sized to hold the
            densest band); (b) NCCL at one rank in this process (tcp on
            127.0.0.1, destroyed after): the gauss-sharded render with D = 1
            bitwise equal to `rasterize`, and the data-parallel step on a 1 x 1
            mesh against `train_step` on the same inputs; then, after the
            library phase with this process's device memory freed, (c) 2 gloo
            ranks sharing cuda:0 (this script with `--rank gauss2`): the
            gauss-sharded render with D = 2 at full width (bitwise, zero
            overflow, gradients within 5e-3) and the data = 2 step's first
            per-image losses against the single-device forward losses (1e-5
            relative); (d) 4 gloo ranks sharing cuda:0 (`--rank cli`), each
            `cli.train.main` with runtime.data_parallel=2
            runtime.gauss_shards=2, the coordinator flags and
            --dist-backend=gloo on the trainer phase's dataset: 24 iterations
            (densify from 8 every 12, opacity reset at 20, evaluation and save
            at 24), then a resume of 8 from the checkpoint: rank 0 alone writes,
            the evaluation's train_psnr finite, every overflow healed at once,
            the resumed step 24; each rank's kernel launches (the kernel table's
            "parallel" path), peak memory and ms per DP step, labelled as ranks
            sharing one card over gloo. Multi-rank NCCL and scaling are not
            measured: the machine has one card;
15. selfcheck: after the library phase, the training self-check
            (`scripts/selfcheck_train.py`) at its defaults on cuda:0: 1,500
            iterations at 128x128 from 8 views of its synthetic scene, once
            through `train_step` and once through the data-parallel step on a
            1 x 1 mesh (NCCL at one rank, opened and closed by the run), each
            held to its gates (best PSNR >= 21 dB, gain >= 6 dB, mean of the
            last 300 iterations' checkpoints >= 20 dB) and to zero overflow,
            with the trajectory, iterations per second and wall time; then
            the module's CLI as a subprocess, 200 iterations with the gates at
            0 (exit 0, its jsonl written);
16. serve_demo: the serving demo's CLI (`scripts/serve_demo.py`) as a
            subprocess at its defaults, 1,000,000 Gaussians / 800x800 / 30
            frames, exact and then --packed: every frame served, zero
            overflow, its record (steady and device ms per frame) and its
            served frames' launches of A, P and B, or B' and not B;
17. bench:  (run after the reference phase, before the training phases
            and any NCCL group of this process) the measurement scripts. In process, `scripts/bench.py`'s `run` at its defaults
            (1,000,000 Gaussians, 800x800, 10 timed calls) in train mode,
            train mode with BENCH_ANISO=8 (row intervals on: A-int), and render
            mode exact, packed (B') and at BENCH_SKIP_ALPHA=0.0625: each with
            zero overflow, every stage of its pie > 0, the card line and the
            launches of its kernels (the kernel table's "bench" path; every
            case launches I in the bench's probe of the entry demand); then,
            outside the count, A, I and A-int (BENCH_ANISO=8), B at C = 3, C,
            P and D against their plain versions on the inputs the train case
            gives them ("at_bench_shapes" in the kernel table) and the aniso-8
            case once more with the eager plain pass in I's place; then one
            subprocess of each CLI, each printing its one JSON line: the
            bench's overflow probe (200,000 Gaussians, budget 262,144:
            overflow > 0), the parity probe at its defaults (50,000
            Gaussians, 512x512, the card against the plain path on the CPU:
            ok) and the train-step bench at its defaults (500,000 Gaussians,
            800x800: zero overflow).
            After it, in process and still before any NCCL group, the
            scaling_kernels phase: A, B at C = 13, C, P and D against their
            plain versions on the inputs the scaling harness's data-parallel
            step gives them at both of the sizes below (`bench_scaling.build`
            for one rank, whose step renders and differentiates batch row 0
            through `train_step.loss_and_grads`; at the flagship size ~32M
            entries in a budget of ~41M slots), with times and bounds
            ("at_scaling_shapes" in the kernel table).

18. scaling: (after the serving demo, before the parallel phase's rank
            groups) the data-parallel scaling harness
            (`scripts/bench_scaling.py`) as a subprocess, whose NCCL ranks
            (1, 2, 4, ... up to the visible cards) are processes of their own,
            at the JAX script's defaults (20,000 + 512 sky Gaussians, 128x128,
            budget 65,536, 10 timed steps) and at 1,010,000 + 512 sky Gaussians
            / 800x800 with the budget sized from the demand: each n with zero
            overflow, finite losses, a device time per step and launches of
            A, P, B, C and D in its ranks (the kernel table's "scaling" path).
            With one card this is n = 1 alone, a per-card baseline of the DP
            step and not a scaling number; the record says so.

19. shading: (after the scaling kernels, before the training phases) kernels S
            and S' (`csrc/shade.cu`: the per-Gaussian shading and its
            gradient) against the plain chain on the card at the cells'
            shapes (3.03M rows RGB, 8.16M rows 13 channels): colours within
            2e-4, every leaf's gradient within 1e-3 of its norm (autograd's
            over the plain chain), two backward runs bitwise, times and byte
            bounds; S' also with a training pool's cotangents (zero past 1.01M
            live rows). `python3 chip_smoke.py --shading` runs this phase
            alone.
20. view_unpack: (after the shading phase) kernel V (`csrc/view_unpack.cu`:
            a training photo's padded float32 canvas from its 8-bit bytes)
            against its plain version (`view_store.unpack_view_plain`) on the
            card, bitwise, at the photo collection's shapes on a 1600x1600
            canvas (1200x1600, 1600x1200 and 1067x1600 photos with sky and
            occluder masks, and a 1067x1600 RGBA frame over a white
            background), into canvases filled with NaN first, with times and
            byte bounds (the stored bytes read, 20 bytes a canvas pixel
            written). The trainer phase's run launches it once an iteration.
            `python3 chip_smoke.py --view-unpack` runs this phase alone.
21. preprocess: (after the view unpack phase) kernels R and R'
            (`csrc/preprocess.cu`: the projection, EWA covariance, conic and
            tile rects, and their gradient) against the plain chain on the
            card at the cells' shapes (8.16M rows at 800x800 with 1.01M live,
            3.03M rows at 1600x1067): every field of R bitwise, R' within
            5e-3 of each leaf's largest gradient (autograd's over the plain
            chain, the cotangents on the rows with tiles), two R' runs
            bitwise, one launch of each a call, times and byte bounds.
            `python3 chip_smoke.py --preprocess` runs this phase alone.

The serve phase also runs `rasterize_aux` (the untightened rects, as in JAX)
on the first frame's inputs on the card and on the CPU: the card's binning
bitwise against the plain binning of its own preprocess, its preprocess
against the CPU's within AUX_*_TOL.

Depth cuts: the trainer phase runs 60 of the default 40,000 iterations, the
eval phase EVAL_ITERS = 30 and RELIT_STEPS = 8 of the relighting CLI's 30
frames, the pretrain phase PRETRAIN_EPOCHS = 5 of the default 100 autoencoder
epochs and PRETRAIN_ITERS = 20 trainer iterations, the parallel phase 24 + 8
trainer iterations with runtime.pool_headroom=2 (of 8); the self-check, the
serving demo and the measurement scripts run at their defaults; no width is
cut.

Each phase prints one JSON line, with the card's nvidia-smi name and power
limit under "card". The last lines are the kernel table, the
nvidia-smi line and {"ok": true, "device": ...}. Any failed check raises, so
the script exits non-zero without the last line; it also exits non-zero when
no CUDA device is present.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import datetime
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from torch.func import functional_call

from relightable3dgaussians_w_torch import pretrain, synthetic, train_step as TS, viewer
from relightable3dgaussians_w_torch.cli import eval_gt_envmaps as cli_eval_gt
from relightable3dgaussians_w_torch.cli import eval_white_light as cli_white
from relightable3dgaussians_w_torch.cli import full_eval as cli_full_eval
from relightable3dgaussians_w_torch.cli import metrics as cli_metrics
from relightable3dgaussians_w_torch.cli import relit_novel_view as cli_relit
from relightable3dgaussians_w_torch.cli import render as cli_render
from relightable3dgaussians_w_torch.cli import train as cli_train
from relightable3dgaussians_w_torch.data.ply import write_ply
from relightable3dgaussians_w_torch.device import card_line
from relightable3dgaussians_w_torch.models import gaussians as G
from relightable3dgaussians_w_torch.models import light_cubemap as cube
from relightable3dgaussians_w_torch.models.nets import EmbeddingNet, fp32_convs
from relightable3dgaussians_w_torch.ops import (binning, bsdf, composite, knn, preprocess,
                                                rasterize, segment_sum)
from relightable3dgaussians_w_torch.ops.cuda import KERNEL_COUNTERS as KERNELS
from relightable3dgaussians_w_torch.ops.cuda import build, launch_counts, reset_launches
from relightable3dgaussians_w_torch.ops.cuda import expand as expand_kernel
from relightable3dgaussians_w_torch.ops.cuda import row_intervals as row_intervals_kernel
from relightable3dgaussians_w_torch.ops.cuda import segment_sum as segment_sum_kernel
from relightable3dgaussians_w_torch.ops.binning import BinningOut
from relightable3dgaussians_w_torch.ops.preprocess import PreprocessOut
from relightable3dgaussians_w_torch.ops.cuda import tile_composite as composite_kernel
from relightable3dgaussians_w_torch.parallel.multihost import free_port
from relightable3dgaussians_w_torch.parallel import collectives as C
from relightable3dgaussians_w_torch.parallel import data_parallel as DP
from relightable3dgaussians_w_torch.parallel import gauss_shard as GS
from relightable3dgaussians_w_torch.parallel import tile_parallel as TP
from relightable3dgaussians_w_torch.parallel.mesh import make_mesh
from relightable3dgaussians_w_torch.renderer import compute_colors, render, render_rgb
from relightable3dgaussians_w_torch.scripts import bench, bench_scaling, selfcheck_train, serve_demo
from relightable3dgaussians_w_torch.scripts.serve_demo import yaw
from relightable3dgaussians_w_torch.trainer import size_entry_budget
from relightable3dgaussians_w_torch.utils.hdr import write_hdr
from relightable3dgaussians_w_torch.utils.timing import device_events, device_ms, median_ms

N_GAUSS = 1_000_000
N_SKY = max(N_GAUSS // 100, 500)   # the serving demo's sky (scripts/serve_demo.py)
RES = 800
FRAMES = 8
TRAIN_STEPS = 6
ANISO = 8.0                    # bench.py's BENCH_ANISO regime: scales[:, 0] *= 8
TRAINER_VIEWS = 8
TRAINER_ITERS = 60
ORBIT_CENTER = np.array([0.0, 0.0, 4.5])   # middle of the scene's depth range
# The trainer phase's schedule (iterations 1-60): opacity resets at 10 (the
# densify start) and 30, plain densify rounds at 20 and 30, sized ones at 40
# and 50; evaluation and save at 60. The densify gradient threshold stays at
# its default (1e-4), which selects Gaussians to split at iteration 20.
TRAINER_SCHEDULE = ["optimizer.densify_from_iter=10", "optimizer.densification_interval=10",
                    "optimizer.opacity_reset_interval=30", "optimizer.densify_until_iter=55"]
WORK_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
SCENE = "synthetic"                     # the trainer phase's dataset, reused by eval
SCENE_DIR = WORK_DIR / "data" / SCENE
EVAL_ITERS = 30
RELIT_STEPS = 8
PRETRAIN_DIR = WORK_DIR / "data" / "pretrain"
PRETRAIN_VIEWS = 32          # a full autoencoder batch of 32
PRETRAIN_EPOCHS = 5          # of the default optimizer.embednet_pretrain_epochs = 100
PRETRAIN_ITERS = 20          # of the default optimizer.iterations = 40,000
# Two NeRF-OSR lighting conditions, one of each name form that
# pretrain.lighting_condition_of reads ("C01_..." and "<condition>_DSC_NNNN"),
# each rendered under its own embedding; its SH prior is that embedding's
# envlight SH: (condition, image name format, embedding index).
CONDITIONS = (("C01", "C01_IMG_{:04d}", 0), ("lk2-day2", "lk2-day2_DSC_{:04d}", 1))
LIBRARY_KNN_SUBSET = 100_000
CUBEMAP_RES, CUBEMAP_CHECK_RES = 512, 64
# Float ops of kernel B' unpacking one staged row: rb * 2^-12, floor, q_r * 4096,
# the remainder, and the two dequantizing products.
UNPACK_OPS_PER_ROW = 6
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, float32 outside tensor cores
EXPAND_OPS_PER_SLOT = 4        # integer ops per written slot
# Kernel I (the row-interval pass) per row: reads mean2d, conic, opacity, rect
# min and max, tiles_touched (44 bytes), writes its count and 8 packed rows
# (36 bytes); float ops: the prelude (24) and 38 for each of the 8 tile rows.
ROW_INTERVAL_BYTES = 80
ROW_INTERVAL_OPS = 24 + 8 * 38
# Float ops of a visited (pixel, entry) pair that the compositor skips: power
# (5 multiplies, 5 adds) and its test; where power <= 0, also expf, alpha
# (multiply, min) and its test. The terminating pair (power, alpha, then
# T * (1 - alpha) under 1e-4) is counted as an alpha skip: a lower bound.
SKIP_POWER_OPS = 11
SKIP_ALPHA_OPS = 15


def composite_ops_per_pair(C):
    """Float ops per contributing (pixel, entry) pair of the forward kernel:
    power (10) and the three tests, expf, alpha (multiply, min),
    T * (1 - alpha), w, 2 per channel for the blend: 25 at C = 3."""
    return 19 + 2 * C


def backward_ops_per_pair(C):
    """Float ops per contributing pair of the backward kernel: the forward's
    replay without the blend (19), c . gbar (2C), the prefix Q (2), dL/dalpha
    (5), dG, dx, dy, G dx, G dy (5), the six geometry terms (17), w gbar (C)
    and one add per gradient value of the pixel reduction (6 + C)."""
    return 54 + 4 * C


def compositor_ops(per_pair, pairs):
    """Float ops of a compositor kernel on a frame with `pair_counts` `pairs`."""
    alpha_skips = pairs["visited"] - pairs["contributing"] - pairs["power_skipped"]
    return (per_pair * pairs["contributing"] + SKIP_POWER_OPS * pairs["power_skipped"]
            + SKIP_ALPHA_OPS * alpha_skips)


def bound(bytes_, ops):
    """(bound_ms, bound_by) from the bytes moved and the float32 operations."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def emit(obj):
    print(json.dumps(obj), flush=True)


def image_errors(got, want):
    err = (got.double() - want.double()).abs().flatten()
    return float(err.max()), float((err > 1e-3).double().mean()), float(err.median())


def check_image(got, want, what):
    mx, frac, med = image_errors(got, want)
    if not (frac < 1e-3 and med < 1e-5):
        raise AssertionError(f"{what}: {frac:.2e} of values off by >1e-3, median {med:.2e}")
    return mx, frac, med


def build_host(dev):
    """The serving host of the full-size scene (`scripts/serve_demo.build_host`:
    N_GAUSS + N_SKY Gaussians at RES x RES, exact frames)."""
    return serve_demo.build_host(N_GAUSS, RES, device=dev)


def frame_inputs(host, deg, dev):
    """Everything render_rgb computes before the rasterizer, for one yaw."""
    p, s, m = host.state.gaussians, host.state.gauss_state, host.cfg.model
    cam = synthetic.camera(RES, RES, viewmat=yaw(deg), device=dev)
    envl, sky = host.mlp(host.state.embeddings[0][None])
    rgb, _ = compute_colors(p, s, envl[0], sky, m.envlight_sh_degree, m.sky_sh_degree,
                            cam.campos, m.specular, m.fix_sky)
    return cam, G.get_xyz(p, s), G.get_scaling(p), G.get_rotation(p), \
        G.get_opacity(p, s)[:, 0], rgb


def pair_counts(feat, tile_start, tile_end, grid_x):
    """The compositor's data-dependent work on this frame, in (pixel, entry)
    pairs: `visited` before each pixel terminates (the terminating pair
    included), of which `contributing` (blended) and `power_skipped` (power > 0;
    counted where exp(min(power, 0)) == 1, which also takes in the rare
    power <= 0 that rounds to G = 1, so the count errs low); and
    `entries_read`, the entry rows a tile needs before its last pixel
    terminates (each pixel visits a prefix of the tile's entries), summed
    over the tiles."""
    counts = tile_end - tile_start
    out = dict(visited=0, contributing=0, power_skipped=0, entries_read=0)
    for t0, t1, length in composite._batches(counts.cpu().numpy(), 256, 1 << 24):
        tids = torch.arange(t0, t1, device=feat.device)
        alpha, aux = composite._tile_batch(feat, tile_start[t0:t1], counts[t0:t1], tids,
                                           grid_x, 16, length)
        _, p_prev, include, _, _ = composite._transmittance(alpha)
        visited = (p_prev >= composite.T_EPS) & aux["valid"][..., None]
        out["visited"] += int(visited.sum())
        out["entries_read"] += int(visited.any(dim=2).sum())
        out["contributing"] += int((visited & include & ~aux["skip"]).sum())
        out["power_skipped"] += int((visited & aux["skip"] & (aux["G"] == 1.0)).sum())
    return out


def expand_args(pre, counts, gx, max_dup):
    """The expansion wrappers' arguments for one frame's PreprocessOut and
    per-Gaussian entry counts (rect or interval)."""
    n = pre.depth.shape[0]
    counts = counts.to(torch.int32).contiguous()
    offsets = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    rank = torch.empty(n, dtype=torch.int64, device=counts.device)
    rank[torch.argsort(pre.depth, stable=True)] = torch.arange(n, device=counts.device)
    rect_w = torch.clamp_min(pre.rect_max[:, 0] - pre.rect_min[:, 0], 1).int().contiguous()
    return counts, offsets, pre.rect_min.contiguous(), rect_w, rank, gx, max_dup


def expand_bytes(counts, max_dup, packed=None):
    """Bytes the expansion must move on these inputs: every Gaussian's count
    and offset read; a Gaussian with entries also reads its rect min, width
    and rank and, with row intervals, its packed rows up to the last nonempty
    one (all of them when the rect runs past them); every slot of the budget
    gets a key and an id."""
    live = counts > 0
    read = counts.shape[0] * (4 + 8) + int(live.sum()) * (8 + 4 + 8) + max_dup * (8 + 4)
    if packed is not None:
        w = packed.long() >> 7
        row = torch.arange(1, w.shape[0] + 1, device=w.device)[:, None]
        last = ((w > 0) * row).amax(0)
        rows = torch.where(counts.long() > w.sum(0), w.shape[0], last)
        read += int(rows[live].sum()) * 4
    return read


def kernels_phase(host, dev):
    rcfg = host.rcfg
    gx, gy = rcfg.grid_x, rcfg.grid_y
    cam, xyz, scl, quat, opa, rgb = frame_inputs(host, -10.0, dev)
    pre = preprocess.preprocess(xyz, scl, quat, cam.viewmat, cam.projmat, cam.tan_fovx,
                                cam.tan_fovy, RES, RES, 16, active=host.state.gauss_state.alive,
                                opacities=opa, skip_alpha=rcfg.skip_alpha)
    n = xyz.shape[0]
    a_row, a_rec = hold_expansion((expand_args(pre, pre.tiles_touched, gx, rcfg.max_dup), {}),
                                  "serving frame")
    total = a_rec["entries"]

    b = binning.bin_gaussians(pre, gx, gy, rcfg.max_dup)
    if int(b.overflow) != 0:
        raise AssertionError(f"entry budget overflow {int(b.overflow)} on the first frame")
    feat = torch.cat([pre.mean2d, pre.conic, opa[:, None], rgb], -1)[b.gauss_id.long()]
    feat = feat.contiguous()
    b_row, b_rec, out_k = hold_forward((feat, b.tile_start, b.tile_end, host.bg_color, gx, gy),
                                       "composite_forward at C = 3")
    img_k, _ = rasterize._assemble_image(*out_k, rcfg, 3)

    record = {"phase": "kernels", "frame": "yaw -10, embedding 0, 800x800",
          "gaussians": n, "entries": total, "max_dup": rcfg.max_dup,
          "pairs": b_rec["pairs"],
          "expand": a_rec, "composite": b_rec}
    table = [
        a_row,
        dict(name="composite_forward", route="cuda",
             source="relightable3dgaussians_w_torch/csrc/tile_composite.cu",
             replaces="relightable3dgaussians_w_tpu/ops/pallas/tile_composite.py:193", **b_row),
    ]
    return table, img_k, record


# The cells' shading shapes: serve-3m-1600's 3.03M rows in RGB, train-1m-800's
# 8.16M-row pool in 13 channels with the view depth.
SHADE_SHAPES = ((3_030_000, 3), (8_160_000, 13))
SHADE_OPS = 405         # float ops a row of the forward (benchmark/roofline.py SHADE_OPS)


def shade_inputs(n, channels, dev, seed=0):
    """Random raw pool rows in front of the camera (1% sky), a bright envlight
    (SH 4) and a sky SH (SH 1), the cells' widths."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    rows = (r(n, 3) * 2 + torch.tensor([0.0, 0.0, 4.5], device=dev), r(n, 4), r(n, 3) * 0.5 - 3,
            r(n, 3), r(n, 1) * 2, r(n, 1) * 2, torch.rand(n, generator=g, device=dev) < 0.01)
    base = r(25, 3) * 0.5
    base[0] += 1.5
    view = torch.tensor([0.0, 0.1, 1.0, -0.5], device=dev) if channels > 3 else None
    return rows, base, r(1, 4, 3) * 0.3, torch.tensor([0.1, -0.2, 0.0], device=dev), view


def shading_phase(dev):
    """Kernels S and S' (`csrc/shade.cu`) against the plain chain on the card at
    the cells' shapes: colours and every leaf's gradient (the plain backward is
    autograd's over the plain chain), two backward runs bitwise, device times
    (`device_ms`) and bounds (bytes: 61 read a row, 4 a channel written; the
    backward reads the rows and the channels' cotangents and writes 48 bytes
    of gradients; operations: SHADE_OPS a row, three times that backward)."""
    from relightable3dgaussians_w_torch.models.light import _fg_lut_quad_on
    from relightable3dgaussians_w_torch.ops import shading
    from relightable3dgaussians_w_torch.ops.cuda import shade as shade_kernel

    lut = _fg_lut_quad_on(dev)
    out, rows_s, rows_b = {}, {}, {}
    for n, C in SHADE_SHAPES:
        rows, base, sky, campos, view = shade_inputs(n, C, dev)
        opts = shading.ShadeOptions(4, 1, C, True, False, False)
        krow = (rows, base, sky.reshape(-1, 3), campos, view, lut, 4, 1)
        fwd = lambda: shade_kernel.shade_forward(*krow, C, True, False, False)
        plain = lambda: shading.shade_rows_plain(*rows, base, sky, campos, view, opts)
        got, want = fwd()[0], plain()[0]
        err = (got - want).abs()
        g_out = torch.randn((n, C), device=dev, generator=torch.Generator(dev).manual_seed(1))
        bwd = lambda: shade_kernel.shade_backward(*krow, True, False, g_out, None)
        k_grads, k_again = bwd(), bwd()
        if not all(torch.equal(a, b) for a, b in zip(k_grads, k_again)):
            raise AssertionError(f"shade_backward at {n} rows: two runs differ")
        xyz, rot, scl, alb, rough, met, is_sky = rows
        leaves = [t.clone().requires_grad_(True) for t in (xyz, rot, alb, rough, met, base, sky)]
        x, r_, a, ro, m, b, s_ = leaves
        c_p, _ = shading.shade_rows_plain(x, r_, scl, a, ro, m, is_sky, b, s_, campos, view, opts)
        loss = (c_p * g_out).sum()
        p_grads = torch.autograd.grad(loss, leaves, retain_graph=True)
        gaps = {}
        for name, kg, pg in zip(("xyz", "rotation", "albedo", "roughness", "metalness",
                                 "envlight", "sky_sh"), k_grads, p_grads):
            d = (kg.reshape(pg.shape).double() - pg.double())
            gaps[name] = float(d.norm() / pg.double().norm().clamp_min(1e-30))
        torch.cuda.synchronize()
        if float(err.max()) > 2e-4 or max(gaps.values()) > 1e-3:
            raise AssertionError(f"shading at {n} rows: colours {float(err.max())}, "
                                 f"gradients {gaps}")
        k_ms, p_ms = device_ms(fwd, 20), device_ms(plain, 3)
        kb_ms = device_ms(bwd, 10)
        # A training pool's cotangents: zero past the 1.01M live rows, which S' skips.
        g_pool = g_out.clone()
        g_pool[min(n, 1_010_000):] = 0.0
        kp_ms = device_ms(lambda: shade_kernel.shade_backward(*krow, True, False, g_pool, None), 10)
        del g_pool
        pb_ms = device_ms(lambda: torch.autograd.grad(loss, leaves, retain_graph=True), 3)
        del loss, c_p, p_grads
        fb = bound(n * (61 + 4 * C), n * SHADE_OPS)
        bb = bound(n * (61 + 4 * C + 48), 3 * n * SHADE_OPS)
        key = f"{n}x{C}"
        out[key] = {"max_abs_err": float(err.max()),
                    "share_over_1e-6": float((err > 1e-6).double().mean()),
                    "grad_norm_gaps": gaps, "ms": k_ms, "plain_ms": p_ms, "bound_ms": fb[0],
                    "bwd_ms": kb_ms, "bwd_ms_live_1010000": kp_ms, "bwd_plain_ms": pb_ms,
                    "bwd_bound_ms": bb[0]}
        rows_s[key] = dict(max_abs_err=float(err.max()), ms=k_ms, plain_ms=p_ms, bound_ms=fb[0],
                           bound_by=fb[1], library_ms=None)
        rows_b[key] = dict(max_abs_err=max(gaps.values()), ms=kb_ms, ms_live_1010000=kp_ms,
                           plain_ms=pb_ms, bound_ms=bb[0], bound_by=bb[1], library_ms=None)
        del rows, krow, got, want, err, g_out, k_grads, k_again, leaves
        torch.cuda.empty_cache()
    replaces = "none: the JAX package's XLA fusion of renderer.compute_colors"
    source = "relightable3dgaussians_w_torch/csrc/shade.cu"
    first, second = (f"{n}x{C}" for n, C in SHADE_SHAPES)
    table = [dict(name="shade_forward", route="cuda", source=source, replaces=replaces,
                  **rows_s[second], at_serve_shapes=rows_s[first]),
             dict(name="shade_backward", route="cuda", source=source, replaces=replaces,
                  **rows_b[second], at_serve_shapes=rows_b[first])]
    return table, {"phase": "shading", "shapes": out}


def shading_main() -> int:
    """`python3 chip_smoke.py --shading`: the device line and the shading phase
    alone."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build(["shade"])
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0), "card": card_line(dev),
          "kernel_build_s": time.perf_counter() - t0})
    table, record = shading_phase(dev)
    emit({**record, "card": card_line(dev)})
    emit({"kernels": table})
    return 0


# The cells' preprocess calls: train-1m-800's 8.16M-row pool at 800x800 (the
# 13-channel training call: opacities, `active`, 1.01M live rows) and
# serve-3m-1600's 3.03M rows at 1600x1067 (every row live).
PRE_SHAPES = ((8_160_000, 800, 800, 1_010_000), (3_030_000, 1600, 1067, 3_030_000))
PRE_FWD_BYTES = 117     # a row: 45 read (means, scales, quats, opacity, active), 72 written
PRE_BWD_BYTES = 104     # a row: 40 of inputs and 24 of cotangents read, 40 written


def preprocess_inputs(n, live, dev, seed=0):
    """A pool's rows as the cells hold them: positions uniform in [-2, 2]^2 x
    [1, 8] in front of the camera, scales exp(N(-4.5, 0.5^2)), random
    rotations, opacities uniform in (0, 1); rows past `live` inactive."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    means = u(n, 3) * torch.tensor([4.0, 4.0, 7.0], device=dev) \
        + torch.tensor([-2.0, -2.0, 1.0], device=dev)
    scales = torch.exp(torch.randn((n, 3), generator=g, device=dev) * 0.5 - 4.5)
    quats = torch.randn((n, 4), generator=g, device=dev)
    quats = quats / quats.norm(dim=-1, keepdim=True)
    active = torch.arange(n, device=dev) < live
    return means, scales, quats, u(n), active


def preprocess_phase(dev):
    """Kernels R and R' (`csrc/preprocess.cu`) against the plain chain on the
    card at the cells' shapes (PRE_SHAPES): every field of R bitwise, R'
    within 5e-3 of each leaf's largest gradient of autograd's over the plain
    chain (the cotangents of the gather's transpose: random on the rows with
    tiles, 0 elsewhere), two R' runs bitwise, one launch each a call
    (`launch_counts`), device times (`device_ms`) and byte bounds
    (PRE_FWD_BYTES, PRE_BWD_BYTES a row)."""
    from relightable3dgaussians_w_torch.ops import preprocess as P

    out, rows_f, rows_b = {}, {}, {}
    for n, W, H, live in PRE_SHAPES:
        means, scales, quats, opac, active = preprocess_inputs(n, live, dev)
        cam = synthetic.camera(W, H, viewmat=np.array(
            [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0.5], [0, 0, 0, 1]], np.float32), device=dev)
        call = lambda fn, m, s, q: fn(m, s, q, cam.viewmat, cam.projmat, cam.tan_fovx,
                                      cam.tan_fovy, W, H, 16, active=active, opacities=opac)
        reset_launches()
        got = call(P.preprocess, means, scales, quats)
        torch.cuda.synchronize()
        counts = launch_counts()
        with torch.no_grad():
            want = call(P.preprocess_plain, means, scales, quats)
        differ = {}
        for f in P.PreprocessOut._fields:
            a, b = getattr(got, f), getattr(want, f)
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            differ[f] = int((a != b).sum())
        del want
        # The gather's transpose: cotangents on the rows with tiles, 0 elsewhere.
        gen = torch.Generator(device=dev).manual_seed(1)
        has = (got.tiles_touched > 0)[:, None]
        g_m = torch.randn((n, 2), generator=gen, device=dev) * has
        g_c = torch.randn((n, 3), generator=gen, device=dev) * has
        leaves = [t.clone().requires_grad_(True) for t in (means, scales, quats)]
        k_pre = call(P.preprocess, *leaves)
        kernel_grads = lambda: torch.autograd.grad([k_pre.mean2d, k_pre.conic], leaves,
                                                   [g_m, g_c], retain_graph=True)
        reset_launches()
        k_grads, k_again = kernel_grads(), kernel_grads()
        torch.cuda.synchronize()
        bwd_counts = launch_counts()
        repeat = all(torch.equal(a, b) for a, b in zip(k_grads, k_again))
        p_pre = call(P.preprocess_plain, *leaves)
        plain_grads = lambda: torch.autograd.grad([p_pre.mean2d, p_pre.conic], leaves,
                                                  [g_m, g_c], retain_graph=True)
        p_grads = plain_grads()
        gaps = {name: float((kg - pg).abs().max() / pg.abs().max().clamp_min(1e-30))
                for name, kg, pg in zip(("means3d", "scales", "quats"), k_grads, p_grads)}
        torch.cuda.synchronize()
        if any(differ.values()) or max(gaps.values()) >= 5e-3 or not repeat \
                or counts["preprocess_forward"] != 1 or bwd_counts["preprocess_backward"] != 2:
            raise AssertionError(f"preprocess at {n} rows: fields differing {differ}, "
                                 f"gradient gaps {gaps}, R' repeats {repeat}, launches "
                                 f"{counts['preprocess_forward']} and "
                                 f"{bwd_counts['preprocess_backward']} (1 and 2 expected)")
        k_ms = device_ms(lambda: call(P.preprocess, means, scales, quats), 20)
        with torch.no_grad():
            p_ms = device_ms(lambda: call(P.preprocess_plain, means, scales, quats), 3)
        kb_ms = device_ms(kernel_grads, 10)
        pb_ms = device_ms(plain_grads, 3)
        fb = bound(n * PRE_FWD_BYTES, 0)
        bb = bound(n * PRE_BWD_BYTES, 0)
        key = f"{n}@{W}x{H}"
        out[key] = {"fields_differing": differ, "grad_max_rel_gaps": gaps,
                    "bwd_bitwise_repeat": repeat, "rows_with_tiles": int(has.sum()),
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": fb[0],
                    "bwd_ms": kb_ms, "bwd_plain_ms": pb_ms, "bwd_bound_ms": bb[0]}
        rows_f[key] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=fb[0],
                           bound_by=fb[1], library_ms=None)
        rows_b[key] = dict(max_abs_err=max(gaps.values()), ms=kb_ms, plain_ms=pb_ms,
                           bound_ms=bb[0], bound_by=bb[1], library_ms=None)
        del got, k_pre, p_pre, k_grads, k_again, p_grads, leaves, means, scales, quats
        torch.cuda.empty_cache()
    replaces = "none: the JAX package's XLA fusion of ops/preprocess.py preprocess"
    source = "relightable3dgaussians_w_torch/csrc/preprocess.cu"
    first, second = (f"{n}@{W}x{H}" for n, W, H, _ in PRE_SHAPES)
    table = [dict(name="preprocess_forward", route="cuda", source=source, replaces=replaces,
                  **rows_f[first], at_serve_shapes=rows_f[second]),
             dict(name="preprocess_backward", route="cuda", source=source, replaces=replaces,
                  **rows_b[first], at_serve_shapes=rows_b[second])]
    return table, {"phase": "preprocess", "shapes": out}


def preprocess_main() -> int:
    """`python3 chip_smoke.py --preprocess`: the device line and the
    preprocess phase alone."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build(["preprocess"])
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0), "card": card_line(dev),
          "kernel_build_s": time.perf_counter() - t0})
    table, record = preprocess_phase(dev)
    emit({**record, "card": card_line(dev)})
    emit({"kernels": table})
    return 0


# Kernel V's cases: (h, w, channels, masks) on a VIEW_CANVAS x VIEW_CANVAS canvas.
VIEW_CANVAS = 1600
VIEW_CASES = ((1200, 1600, 3, True), (1600, 1200, 3, True), (1067, 1600, 3, True),
              (1067, 1600, 4, False))


def view_unpack_phase(dev):
    """Kernel V (`csrc/view_unpack.cu`) against its plain version on the card,
    bitwise, at VIEW_CASES: the three canvases (image, sky mask, occluder
    mask), written over NaN so that every element is checked; device times
    (`device_ms`) and the byte bound (h w (channels + masks) read, 20 bytes a
    canvas pixel written)."""
    from relightable3dgaussians_w_torch.data.view_store import unpack_view_plain
    from relightable3dgaussians_w_torch.ops.cuda import view_unpack

    H = W = VIEW_CANVAS
    canvas = lambda: (torch.full((H, W, 3), math.nan, device=dev),
                      torch.full((H, W), math.nan, device=dev),
                      torch.full((H, W), math.nan, device=dev))
    cases, rows = {}, {}
    for h, w, channels, masks in VIEW_CASES:
        g = torch.Generator(device=dev).manual_seed(h * 7 + w + channels)
        b = lambda *shape: torch.randint(0, 256, shape, generator=g, device=dev,
                                         dtype=torch.uint8)
        rgb = b(h, w, channels)
        sky, occ = (b(h, w), b(h, w)) if masks else (None, None)
        bg = 1.0 if channels == 4 else None
        got, want = canvas(), canvas()
        before = view_unpack.launches
        view_unpack.unpack_view(rgb, sky, occ, bg, got)
        unpack_view_plain(rgb, sky, occ, bg, want)
        torch.cuda.synchronize()
        if view_unpack.launches != before + 1:
            raise AssertionError(f"view_unpack at {h}x{w}: {view_unpack.launches - before} "
                                 "launches of V, 1 expected")
        differ = sum(int((a != x).sum()) for a, x in zip(got, want))   # NaN != NaN
        if differ:
            raise AssertionError(f"view_unpack at {h}x{w}x{channels}: {differ} elements "
                                 "differ from the plain version")
        out = canvas()
        k_ms = device_ms(lambda: view_unpack.unpack_view(rgb, sky, occ, bg, out), 20)
        p_ms = device_ms(lambda: unpack_view_plain(rgb, sky, occ, bg, out), 3)
        vb = bound(h * w * (channels + 2 * masks) + H * W * 20, 0)
        key = f"{h}x{w}x{channels}" + ("_masks" if masks else "")
        cases[key] = {"elements_differ": differ, "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": vb[0], "roofline_pct": 100 * vb[0] / k_ms}
        rows[key] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=vb[0],
                         bound_by=vb[1], library_ms=None)
        del rgb, sky, occ, got, want, out
    first = next(iter(rows))
    row = dict(name="view_unpack", route="cuda",
               source="relightable3dgaussians_w_torch/csrc/view_unpack.cu",
               replaces="none: the JAX package keeps every padded float32 canvas "
                        "(trainer.pad_cameras) on the device",
               **rows[first], at_collection_shapes=rows)
    return [row], {"phase": "view_unpack", "canvas": [H, W], "cases": cases}


def view_unpack_main() -> int:
    """`python3 chip_smoke.py --view-unpack`: the device line and the view
    unpack phase alone."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build(["view_unpack"])
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0), "card": card_line(dev),
          "kernel_build_s": time.perf_counter() - t0})
    table, record = view_unpack_phase(dev)
    emit({**record, "card": card_line(dev)})
    emit({"kernels": table})
    return 0


def stages_phase(host, dev, reps=5):
    """Median CUDA-event time of each stage of one frame (yaw 0)."""
    rcfg, p, s, m = host.rcfg, host.state.gaussians, host.state.gauss_state, host.cfg.model
    cam = synthetic.camera(RES, RES, viewmat=yaw(0.0), device=dev)
    times = {}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        envl, sky = host.mlp(host.state.embeddings[0][None])
        ev[1].record()
        xyz, scl, quat = G.get_xyz(p, s), G.get_scaling(p), G.get_rotation(p)
        opa = G.get_opacity(p, s)[:, 0]
        rgb, _ = compute_colors(p, s, envl[0], sky, m.envlight_sh_degree, m.sky_sh_degree,
                                cam.campos, m.specular, m.fix_sky)
        ev[2].record()
        pre = preprocess.preprocess(xyz, scl, quat, cam.viewmat, cam.projmat, cam.tan_fovx,
                                    cam.tan_fovy, RES, RES, 16, active=s.alive, opacities=opa,
                                    skip_alpha=rcfg.skip_alpha)
        ev[3].record()
        b = binning.bin_gaussians(pre, rcfg.grid_x, rcfg.grid_y, rcfg.max_dup)
        ev[4].record()
        feat = torch.cat([pre.mean2d, pre.conic, opa[:, None], rgb], -1)[b.gauss_id.long()]
        ev[5].record()
        out = composite_kernel.composite_forward(feat, b.tile_start, b.tile_end,
                                                 host.bg_color, rcfg.grid_x, rcfg.grid_y)
        ev[6].record()
        img, _ = rasterize._assemble_image(*out, rcfg, 3)
        (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu()
        ev[7].record()
        torch.cuda.synchronize()
        for i, name in enumerate(("mlp", "shading", "preprocess", "binning", "gather",
                                  "composite", "quantize_copy")):
            times.setdefault(name, []).append(ev[i].elapsed_time(ev[i + 1]))
    med = {k: float(np.median(v)) for k, v in times.items()}

    # Device busy share of whole frames (the viewer's frame function, back to
    # back): kernel and copy time from the profiler over host wall time.
    frame = lambda: viewer._frame_u8(host.state, envl[0], sky, cam, host.bg_color, rcfg,
                                     m.envlight_sh_degree, m.sky_sh_degree, m.specular,
                                     m.fix_sky, dev)[0].cpu()
    frame()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            frame()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    dev_events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3 / reps
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]
    return {"phase": "stages", "frame": "yaw 0, 800x800", "median_ms": med,
          "sum_ms": sum(med.values()), "profiled_frame_wall_ms": wall_ms,
          "profiled_device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms > 0 else None,
          "kernels_per_frame": sum(e.count for e in dev_events) / reps,
          "top_device_ms_per_frame": {e.key[:60]: e.self_device_time_total / 1e3 / reps
                                      for e in top}}


def serve_frames(host, cam0, dev):
    """FRAMES json requests (yaw -10..10) from the serving demo's client through
    the port's ViewerServer (`scripts/serve_demo.serve_frames`): the client's
    [(seconds, frame bytes)] and, per served frame, the kernels' launches, the
    entry overflow (which must be 0) and the entry count."""
    result, per_frame = serve_demo.serve_frames(host, cam0, FRAMES, train=True)
    for i, f in enumerate(per_frame):
        if f["overflow"] != 0:
            raise AssertionError(f"frame {i}: entry overflow {f['overflow']}")
    return result, per_frame


def serve_phase(host, cam0, ref_img, dev):
    reset_launches()
    result, per_frame = serve_frames(host, cam0, dev)
    launches = launch_counts()
    for i, f in enumerate(per_frame):
        if f["expand_entries"] < 1 or f["permute_entries"] < 1 or f["composite_forward"] < 1:
            raise AssertionError(f"frame {i}: kernel launches {f}")
    # The first request is the kernel phase's frame: same bytes up to a
    # truncation at a float boundary.
    first = np.frombuffer(result[0][1], np.uint8).astype(int)
    want = (torch.clamp(ref_img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy().ravel()
    diff = np.abs(first - want)
    if diff.max() > 1 or (diff > 0).mean() > 1e-3:
        raise AssertionError(f"served frame differs from the kernel phase's: max {diff.max()}")
    if first.max() == first.min():
        raise AssertionError("served frame is constant")
    steady = [t * 1e3 for t, _ in result[1:]]
    record = {"phase": "serve", "frames": FRAMES, "resolution": [RES, RES],
          "entries_per_frame": [f["entries"] for f in per_frame], "overflow": 0,
          "launches": {k: launches[k] for k in ("expand_entries", "composite_forward")},
          "first_frame_ms": result[0][0] * 1e3,
          "steady_ms_per_frame_mean": float(np.mean(steady)),
          "steady_ms_per_frame_median": float(np.median(steady)),
          "first_frame_bytes_off_by_one": int((diff > 0).sum()),
          "rasterize_aux": rasterize_aux_check(host, dev)}
    return launches, result, record


# rasterize_aux's preprocess on the card against the CPU's: the largest
# difference of a projected center (pixels) and of a depth (relative) over the
# Gaussians both keep, and the share of Gaussians whose tile count differs.
AUX_MEAN2D_TOL, AUX_DEPTH_TOL, AUX_TILES_SHARE_TOL = 1e-2, 1e-5, 1e-4


def rasterize_aux_check(host, dev):
    """`rasterize_aux` (preprocess and binning of the untightened rects, no
    compositing) on the first served frame's inputs, on the card and on the
    CPU's plain route: the card's binning bitwise against the CPU's plain
    binning of the card's own preprocess (kernels A and P through the public
    call), and the card's preprocess against the CPU's within AUX_*_TOL, the
    two routes' entry counts side by side. Outside the serve path's launch
    count."""
    cam, xyz, scl, quat, _, _ = frame_inputs(host, -10.0, dev)
    alive, rcfg = host.state.gauss_state.alive, host.rcfg
    pre, bins = rasterize.rasterize_aux(xyz, scl, quat, cam, rcfg, active=alive, device=dev)
    cpu = lambda xs: [x.cpu() for x in xs]
    want = binning.bin_gaussians(PreprocessOut(*cpu(pre)), rcfg.grid_x, rcfg.grid_y,
                                 rcfg.max_dup)
    differ = [k for k, a, b in zip(BinningOut._fields, cpu(bins), want) if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"rasterize_aux on the card: binning differs from the plain "
                             f"binning of its preprocess in {differ}")
    pre_p, bins_p = rasterize.rasterize_aux(*cpu((xyz, scl, quat)), rasterize.CameraMatrices(*cpu(cam)),
                                            rcfg, active=alive.cpu(), device="cpu")
    pre_c = PreprocessOut(*cpu(pre))
    both = (pre_c.radius > 0) & (pre_p.radius > 0)
    mean2d_err = float((pre_c.mean2d - pre_p.mean2d)[both].abs().max())
    depth_err = float(((pre_c.depth - pre_p.depth) / pre_p.depth)[both].abs().max())
    tiles_share = float((pre_c.tiles_touched != pre_p.tiles_touched).float().mean())
    rec = {"binning_bitwise_to_plain": True, "frame": "yaw -10", "rects": "untightened",
           "entries": int(bins.num_entries), "entries_cpu": int(bins_p.num_entries),
           "visible": int((pre.radius > 0).sum()), "visible_cpu": int((pre_p.radius > 0).sum()),
           "overflow": int(bins.overflow), "mean2d_max_abs_err_px": mean2d_err,
           "depth_max_rel_err": depth_err, "tiles_touched_differ_share": tiles_share}
    if not (mean2d_err <= AUX_MEAN2D_TOL and depth_err <= AUX_DEPTH_TOL
            and tiles_share <= AUX_TILES_SHARE_TOL):
        raise AssertionError(f"rasterize_aux: the card's preprocess against the CPU's: {rec}")
    return rec


def serve_packed_phase(host, cam0, exact, exact_record, dev):
    """The serve phase's sweep with runtime.serve_packed_rgb=true (kernel B'),
    each frame against the exact mode's frame `exact` at the same camera; then
    B' on the first frame's inputs against its plain version and against B on
    the dequantized colors."""
    cfg = copy.deepcopy(host.cfg)
    cfg.runtime.serve_packed_rgb = True
    phost = serve_demo.ServingHost(host.W, host.H, host.rcfg, cfg, host.mlp, host.state,
                                   host.bg_color, host.device)
    reset_launches()
    result, per_frame = serve_frames(phost, cam0, dev)
    launches = launch_counts()
    off_by_one, max_diff = [], 0
    for i, (f, (_, buf), (_, ebuf)) in enumerate(zip(per_frame, result, exact)):
        if f["composite_forward_packed"] < 1 or f["composite_forward"] != 0 \
                or f["expand_entries"] < 1 or f["permute_entries"] < 1:
            raise AssertionError(f"packed frame {i}: kernel launches {f}")
        diff = np.abs(np.frombuffer(buf, np.uint8).astype(int) - np.frombuffer(ebuf, np.uint8))
        if diff.max() > 1:
            raise AssertionError(f"packed frame {i}: a byte differs by {diff.max()} from the "
                                 "exact frame")
        off_by_one.append(int((diff > 0).sum()))
        max_diff = max(max_diff, int(diff.max()))

    # B' on the first frame's inputs.
    rcfg = host.rcfg
    gx, gy = rcfg.grid_x, rcfg.grid_y
    cam, xyz, scl, quat, opa, rgb = frame_inputs(host, -10.0, dev)
    pre = preprocess.preprocess(xyz, scl, quat, cam.viewmat, cam.projmat, cam.tan_fovx,
                                cam.tan_fovy, RES, RES, 16, active=host.state.gauss_state.alive,
                                opacities=opa, skip_alpha=rcfg.skip_alpha)
    b = binning.bin_gaussians(pre, gx, gy, rcfg.max_dup)
    if int(b.overflow) != 0:
        raise AssertionError(f"entry budget overflow {int(b.overflow)} on the first frame")
    rb, g = composite.pack_rb(rgb)
    head = torch.cat([pre.mean2d, pre.conic, opa[:, None]], -1)
    gid = b.gauss_id.long()
    packed = torch.cat([head, rb[:, None], g[:, None]], -1)[gid].contiguous()
    deq = torch.cat([head, composite.unpack_rb(rb, g)], -1)[gid].contiguous()
    args = (b.tile_start, b.tile_end, host.bg_color, gx, gy)
    out_k = composite_kernel.composite_forward_packed(packed, *args)
    out_b = composite_kernel.composite_forward(deq, *args)
    out_p = composite.composite_forward_packed(packed, *args)
    torch.cuda.synchronize()
    if not (torch.equal(out_k[0], out_b[0]) and torch.equal(out_k[1], out_b[1])):
        raise AssertionError("B' differs from B on the dequantized colors")
    img_k, tfin_k = rasterize._assemble_image(*out_k, rcfg, 3)
    img_p, tfin_p = rasterize._assemble_image(*out_p, rcfg, 3)
    img_err = check_image(img_k, img_p, "composite_forward_packed image")
    tfin_err = check_image(tfin_k, tfin_p, "composite_forward_packed final transmittance")
    k_ms = median_ms(lambda: composite_kernel.composite_forward_packed(packed, *args), 20)
    b_ms = median_ms(lambda: composite_kernel.composite_forward(deq, *args), 20)
    p_ms = median_ms(lambda: composite.composite_forward_packed(packed, *args), 10)
    entries = int(b.num_entries)
    pairs = pair_counts(deq, b.tile_start, b.tile_end, gx)
    T, P = gx * gy, 256
    k_bound = bound(pairs["entries_read"] * 8 * 4 + T * 2 * 8 + 3 * 4 + T * P * 4 * 4,
                    compositor_ops(composite_ops_per_pair(3), pairs)
                    + UNPACK_OPS_PER_ROW * pairs["entries_read"])
    steady = [t * 1e3 for t, _ in result[1:]]
    record = {"phase": "serve_packed", "frames": FRAMES, "resolution": [RES, RES],
              "entries_per_frame": [f["entries"] for f in per_frame], "overflow": 0,
              "launches": {k: launches[k] for k in ("expand_entries", "composite_forward",
                                                     "composite_forward_packed")},
              "bytes_off_by_one_vs_exact_per_frame": off_by_one,
              "max_byte_diff_vs_exact": max_diff,
              "first_frame_ms": result[0][0] * 1e3,
              "steady_ms_per_frame_median": float(np.median(steady)),
              "steady_ms_per_frame_mean": float(np.mean(steady)),
              "exact_first_frame_ms": exact_record["first_frame_ms"],
              "exact_steady_ms_per_frame_median": exact_record["steady_ms_per_frame_median"],
              "kernel_first_frame": {
                  "entries": entries, "pairs": pairs,
                  "b_prime_bitwise_equal_to_b_on_dequantized": True,
                  "image_max_abs_err": img_err[0], "image_frac_over_1e-3": img_err[1],
                  "image_median_err": img_err[2], "tfin_max_abs_err": tfin_err[0],
                  "b_prime_ms": k_ms, "b_on_dequantized_ms": b_ms, "plain_ms": p_ms,
                  "bound_ms": k_bound[0]}}
    row = dict(name="composite_forward_packed", route="cuda",
               source="relightable3dgaussians_w_torch/csrc/tile_composite.cu",
               replaces="relightable3dgaussians_w_tpu/ops/pallas/tile_composite.py:249",
               max_abs_err=img_err[0], ms=k_ms, plain_ms=p_ms, bound_ms=k_bound[0],
               bound_by=k_bound[1], library_ms=None)
    return launches, row, record


def reference_phase(dev):
    """A small scene on the card against the plain path on the CPU."""
    p, s = synthetic.synthetic_scene(n=2000, n_sky=200, seed=3)
    rng = np.random.RandomState(5)
    envl = torch.as_tensor(rng.uniform(0, 0.5, (25, 3)).astype(np.float32))
    sky = torch.as_tensor(rng.uniform(0, 0.3, (1, 4, 3)).astype(np.float32))
    cam = synthetic.camera(64, 64)
    rcfg = rasterize.RasterizerConfig(width=64, height=64, max_dup=1 << 15)
    bg = torch.tensor([0.1, 0.2, 0.3])
    img_c, aux_c = render_rgb(p, s, envl, sky, cam, rcfg, bg, device=dev)
    img_p, aux_p = render_rgb(p, s, envl, sky, cam, rcfg, bg, device="cpu")
    if int(aux_c.num_entries) != int(aux_p.num_entries):
        raise AssertionError("entry counts differ between the card and the CPU")
    err = check_image(img_c.cpu(), img_p, "64x64 render vs CPU plain path")
    return {"phase": "reference", "scene": "2000+200 Gaussians, 64x64",
          "entries": int(aux_c.num_entries), "image_max_abs_err": err[0],
          "image_frac_over_1e-3": err[1], "image_median_err": err[2]}


class TrainSetup:
    """The training slice's inputs at full width: state, camera, target, masks."""

    def __init__(self, host, cam0, dev):
        self.cfg, self.rcfg, self.mlp = host.cfg, host.rcfg, host.mlp
        st = host.state
        self.state = TS.init_train_state(st.gaussians, st.gauss_state, host.mlp, st.embeddings)
        self.cam = cam0
        self.bg = torch.zeros(3, device=dev)
        self.ones = torch.ones((RES, RES), device=dev)
        m = self.cfg.model
        with torch.no_grad():
            # Target: the port's own render of the scene under embedding 1.
            envl, sky = host.mlp(st.embeddings[1][None])
            self.gt = render(st.gaussians, st.gauss_state, envl[0], sky, cam0, self.rcfg,
                             self.bg, self.ones, m.envlight_sh_degree, m.sky_sh_degree,
                             m.specular, m.fix_sky, debug=False, device=dev).render.contiguous()
        self.gen = torch.Generator(device=dev).manual_seed(0)

    def args(self, draws):
        """train_step's arguments after the state."""
        return (self.cam, self.gt, self.ones, self.ones, 0, draws, self.bg, self.mlp, self.cfg,
                self.rcfg)


def autograd_node(root, name):
    """The first node of class `name` in the autograd graph below `root`."""
    seen, todo = set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == name:
            return node
        todo.extend(f for f, _ in node.next_functions)
    raise LookupError(f"no {name} node in the autograd graph")


@contextlib.contextmanager
def recording(module, name):
    """The (args, kwargs) of every call of `module.name` inside the block."""
    calls, inner = [], getattr(module, name)

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return inner(*args, **kwargs)

    setattr(module, name, recorded)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def recorded_expansions(fn):
    """(fn()'s result, the (args, kwargs) of every `expand_entries` call it made,
    and those of every call of the row-interval kernel's wrapper)."""
    with recording(expand_kernel, "expand_entries") as calls, \
            recording(row_intervals_kernel, "row_intervals") as iv_calls:
        return fn(), calls, iv_calls


def eager_row_intervals(pre, opacities, tile=16, skip_alpha=1.0 / 255.0):
    """The row-interval pass as the port ran it before kernel I: the eager
    plain version, its rows converted to int32."""
    counts, packed = preprocess.row_intervals_plain(pre, opacities, tile, skip_alpha)
    return counts, packed.to(torch.int32)


def graph_inputs(forward, leaves, n, what):
    """The kernels' inputs on one differentiable call `forward() -> (loss,
    overflow)` over `leaves` of n Gaussians: the expansion's arguments as the
    binning passes them, and from the autograd graph the compositor's saved
    inputs and outputs, the cotangents that reach it and the gather, and the
    gather's segment layout (the binning's `seg_bounds` and `slot_pos`) with
    the entry ids it stands for."""
    (loss, overflow), expand_calls, iv_calls = recorded_expansions(forward)
    if int(overflow) != 0:
        raise AssertionError(f"entry budget overflow {int(overflow)} on {what}")
    comp = autograd_node(loss.grad_fn, "_CompositeTilesBackward")
    gather = autograd_node(loss.grad_fn, "_GatherRowsBackward")
    feat, tile_start, tile_end, bg, rgb, tfin = (t.detach() for t in comp.saved_tensors)
    bounds, order = gather.saved_tensors
    got = {}
    comp.register_prehook(lambda g: got.update(g_rgb=g[0], g_tfin=g[1]))
    gather.register_prehook(lambda g: got.update(d_rows=g[0]))
    torch.autograd.grad(loss, leaves, allow_unused=True)
    zero_if_none = lambda g, like: torch.zeros_like(like) if g is None else g.contiguous()
    return dict(expand=expand_calls[0], intervals=iv_calls[0] if iv_calls else None,
                feat=feat, tile_start=tile_start, tile_end=tile_end,
                bg=bg, rgb=rgb, tfin=tfin,
                g_rgb=zero_if_none(got["g_rgb"], rgb),     # a loss may read no T_final
                g_tfin=zero_if_none(got["g_tfin"], tfin),
                d_rows=zero_if_none(got["d_rows"], feat), n=n, entries=int(bounds[-1]),
                bounds=bounds, order=order,
                ids=segment_sum.layout_ids(bounds, order, feat.shape[0]))


def step_inputs(state, cam, gt, sky, occ, uid, mlp, cfg, rcfg, bg, dev, draws=None):
    """The kernels' inputs on one training step of `state` (`graph_inputs` of
    the port's own `forward_loss`), with `draws` (default: drawn from seed 0)."""
    if draws is None:
        draws = TS.make_draws(torch.Generator(device=dev).manual_seed(0), mlp, cfg)
    params = TS.tree_map(lambda p: p.detach().requires_grad_(True), state.params)
    n = state.gauss_state.alive.shape[0]
    probe = torch.zeros((n, 2), device=dev, requires_grad=True)

    def forward():
        loss, aux = TS.forward_loss(params, state.gauss_state, probe, mlp, cam, gt, sky, occ,
                                    uid, draws, state.step, cfg, rcfg, bg, device=dev)
        return loss, aux["overflow"]

    return graph_inputs(forward, TS.tree_leaves(params) + [probe], n, "the training frame")


def hold_step_kernels(x, rcfg, dev, plain_iters=3):
    """Kernels B (C = 13 on a training step), C, P and D on one call's inputs
    (`step_inputs`, `graph_inputs`) against their plain versions, with times and bounds:
    (table rows, record). The plain compositor is timed over `plain_iters`
    calls."""
    feat, ts_, te_, bg, rgb, tfin = (x[k] for k in ("feat", "tile_start", "tile_end", "bg",
                                                    "rgb", "tfin"))
    g_rgb, g_tfin, d_rows, gid, n = (x[k] for k in ("g_rgb", "g_tfin", "d_rows", "ids", "n"))
    gx, gy = rcfg.grid_x, rcfg.grid_y
    C = feat.shape[1] - 6
    T, P = gx * gy, 256
    entries = x["entries"]

    b_row, b_rec, _ = hold_forward((feat, ts_, te_, bg, gx, gy), f"composite_forward at C = {C}",
                                   plain_iters)
    pairs = b_rec["pairs"]

    # C: compositor backward
    args = (feat, ts_, te_, bg, rgb, tfin, g_rgb, g_tfin, gx, gy)
    d_k, dbg_k = composite_kernel.composite_backward(*args)
    d_k2, _ = composite_kernel.composite_backward(*args)
    d_p, dbg_p = composite.composite_backward(feat, ts_, te_, bg, gx, gy, g_rgb, g_tfin)
    torch.cuda.synchronize()
    if not torch.equal(d_k, d_k2):
        raise AssertionError("composite_backward kernel is not bitwise repeatable")
    if not torch.isfinite(d_k).all():
        raise AssertionError("composite_backward kernel produced non-finite values")
    c_rel = {}
    for name, cols in (("mean2d", slice(0, 2)), ("conic", slice(2, 5)),
                       ("opacity", slice(5, 6)), ("colors", slice(6, None))):
        ref = d_p[:, cols].abs().max()
        c_rel[name] = float((d_k[:, cols] - d_p[:, cols]).abs().max() / ref)
        if not (ref > 0 and c_rel[name] < 5e-3):
            raise AssertionError(f"composite_backward {name}: max rel err {c_rel[name]:.3e}")
    # Rows no pixel blends are exactly zero in both, and no others: a predicate
    # the kernel computes otherwise than the plain version would show here.
    zero_k, zero_p = (d_k == 0).all(1), (d_p == 0).all(1)
    if not torch.equal(zero_k, zero_p):
        raise AssertionError(f"composite_backward: {int((zero_k != zero_p).sum())} entry rows "
                             "are zero in one version only")
    c_err = float((d_k - d_p).abs().max())
    c_ms = median_ms(lambda: composite_kernel.composite_backward(*args), 10)
    c_plain_ms = median_ms(lambda: composite.composite_backward(
        feat, ts_, te_, bg, gx, gy, g_rgb, g_tfin), plain_iters)
    # The entry rows a tile visits are read, every entry's gradient row written.
    c_bound = bound((pairs["entries_read"] + entries) * feat.shape[1] * 4 + T * 2 * 8
                    + T * P * (C + 3) * 4,
                    compositor_ops(backward_ops_per_pair(C), pairs))

    # P: the binning's permutation kernel, on the sort this step's layout
    # came from (`binning_sort`), bitwise against its plain version.
    bounds, order = x["bounds"], x["order"]
    sort = binning_sort(bounds, order)
    p_k = segment_sum_kernel.permute_entries(*sort)
    p_p = binning.permute_entries_plain(*sort[:2])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(p_k, p_p)) or not torch.equal(p_k[1], order):
        raise AssertionError("permute_entries differs from its plain version")
    p_launch = lambda: segment_sum_kernel.permute_entries(*sort)
    p_ms, p_event_ms = device_ms(p_launch, 20), median_ms(p_launch, 20)
    p_plain_ms = median_ms(lambda: binning.permute_entries_plain(*sort[:2]), 20)
    # perm and gid read for each real entry, gauss_id and slot_pos written per slot
    p_bound = bound(entries * (8 + 4) + order.shape[0] * (4 + 4), 0)

    # D: segment sum of the entry gradient rows into Gaussian rows, on both
    # routes: the binning's layout, as the rasterizer's gather takes it (timed
    # with P, which builds the layout's order in the binning), and the general
    # entry segment_sum_rows(rows, ids, n) (a sort of the ids, then the kernel).
    routes = {"binned": lambda: segment_sum_kernel.segment_sum_ordered(
                  d_rows, bounds, segment_sum_kernel.permute_entries(*sort)[1]),
              "general": lambda: segment_sum_kernel.segment_sum_rows(d_rows, gid, n)}
    got = {route: (fn(), fn()) for route, fn in routes.items()}
    s_p = segment_sum.segment_sum_rows_plain(d_rows, gid, n)
    torch.cuda.synchronize()
    d_rel = {}
    for route, (s_k, s_k2) in got.items():
        if not torch.equal(s_k, s_k2):
            raise AssertionError(f"segment_sum kernel ({route}) is not bitwise repeatable")
        d_rel[route] = float((s_k - s_p).abs().max() / s_p.abs().max())
        if not d_rel[route] < 1e-5:
            raise AssertionError(f"segment_sum kernel ({route}): max rel err {d_rel[route]:.3e}")
    routes_equal = torch.equal(got["binned"][0], got["general"][0])
    d_err = max(float((s_k - s_p).abs().max()) for s_k, _ in got.values())
    del got
    # Device times (P's and D's kernels), and beside them the event time of
    # the route.
    d_ms, d_event_ms = device_ms(routes["binned"], 20), median_ms(routes["binned"], 20)
    d_parts = {"kernel": device_ms(lambda: segment_sum_kernel.segment_sum_ordered(
                   d_rows, bounds, order), 20),
               "permute_entries": p_ms,
               "general_route": device_ms(routes["general"], 20)}
    d_plain_ms = median_ms(lambda: segment_sum.segment_sum_rows_plain(d_rows, gid, n), 20)
    zeros = torch.zeros((n + 1, d_rows.shape[1]), device=dev)   # row n: the dropped slots
    gid64 = gid.long()
    d_lib_ms = device_ms(lambda: zeros.index_add_(0, gid64, d_rows), 20)
    D, F = d_rows.shape
    # The sum reads the real entries' rows and ids once and writes the Gaussian
    # rows once; the budget's unused slots are dropped unread.
    d_bound = bound(entries * (F * 4 + 4) + n * F * 4, entries * F)

    record = {"gaussians": n, "entries": entries, "slots": D, "pairs": pairs,
              f"composite_forward_c{C}": b_rec,
              "composite_backward": {"max_rel_err_by_group": c_rel, "bitwise_repeatable": True,
                                     "zero_rows_as_plain": int(zero_p.sum()),
                                     "d_bg_max_abs_err": float((dbg_k - dbg_p).abs().max()),
                                     "ms": c_ms, "plain_ms": c_plain_ms},
              "permute_entries": {"bitwise_equal": True, "ms": p_ms, "event_ms": p_event_ms,
                                  "plain_ms": p_plain_ms, "bound_ms": p_bound[0]},
              "segment_sum": {"max_rel_err_by_route": d_rel, "bitwise_repeatable": True,
                              "routes_bitwise_equal": routes_equal, "ms": d_ms,
                              "event_ms": d_event_ms,
                              "ms_parts": d_parts, "plain_ms": d_plain_ms,
                              "index_add_ms": d_lib_ms}}
    cu = "relightable3dgaussians_w_torch/csrc/"
    table = [
        dict(name=f"composite_forward_c{C}", route="cuda", source=cu + "tile_composite.cu",
             replaces="relightable3dgaussians_w_tpu/ops/pallas/tile_composite.py:193", **b_row),
        dict(name="composite_backward", route="cuda", source=cu + "tile_composite.cu",
             replaces="relightable3dgaussians_w_tpu/ops/pallas/tile_composite.py:327",
             max_abs_err=c_err, ms=c_ms, plain_ms=c_plain_ms, bound_ms=c_bound[0],
             bound_by=c_bound[1], library_ms=None),
        dict(name="segment_sum_rows", route="cuda", source=cu + "segment_sum.cu",
             replaces="relightable3dgaussians_w_tpu/ops/pallas/segment_sum.py:44",
             max_abs_err=d_err, ms=d_ms, event_ms=d_event_ms, ms_parts=d_parts,
             plain_ms=d_plain_ms,
             bound_ms=d_bound[0], bound_by=d_bound[1], library_ms=d_lib_ms),
        dict(name="permute_entries", route="cuda", source=cu + "segment_sum.cu",
             replaces="relightable3dgaussians_w_tpu/ops/pallas/segment_sum.py:138",
             max_abs_err=0.0, ms=p_ms, event_ms=p_event_ms, plain_ms=p_plain_ms,
             bound_ms=p_bound[0], bound_by=p_bound[1], library_ms=None),
    ]
    return table, record


def binning_sort(bounds, order):
    """The arguments the binning passed `permute_entries` for a segment layout
    (`step_inputs`): the expansion's ids (Gaussian g on the slots of its run,
    0 past them), the stable sort's permutation (the inverse of `order`) and
    the entry count (no overflow: the budget holds every entry)."""
    D = order.shape[0]
    slots = torch.arange(D, device=order.device)
    perm = torch.empty_like(slots).scatter_(0, order.long(), slots)
    gid = torch.zeros(D, dtype=torch.int32, device=order.device)
    seg = torch.repeat_interleave(torch.arange(bounds.shape[0] - 1, device=order.device,
                                               dtype=torch.int32), bounds.diff())
    gid[: seg.shape[0]] = seg
    return gid, perm, bounds[-1]


def hold_expansion(call, label):
    """Kernel A (rects) or A-int (row intervals: a `packed` keyword) on the
    arguments the binning passed it (`step_inputs`'s "expand", or built from a
    frame) against its plain version, bitwise, also with a budget of half the
    entries, with times and its byte bound: the kernels line's row and a
    record (keys "a_*" or "a_int_*")."""
    args, kwargs = call
    packed = kwargs.get("packed")
    name, key = ("expand_entries", "a") if packed is None else ("expand_entries_intervals",
                                                                 "a_int")
    counts, max_dup = args[0], args[-1]
    # As called, then with a budget of half the entries (an overflow: the
    # budget clamp and the unused-slot fill).
    short = max(min(int(counts.sum()), max_dup) // 2, 1)
    for budget in (max_dup, short):
        call_args = args[:-1] + (budget,)
        keys_k, gid_k = expand_kernel.expand_entries(*call_args, packed=packed)
        keys_p, gid_p = binning.expand_entries_plain(*call_args, packed=packed)
        torch.cuda.synchronize()
        if not (torch.equal(keys_k, keys_p) and torch.equal(gid_k, gid_p)):
            raise AssertionError(f"{label}: {name} differs from its plain version at a "
                                 f"budget of {budget}")
    del keys_k, gid_k, keys_p, gid_p
    launch = lambda: expand_kernel.expand_entries(*args, packed=packed)
    k_ms, k_event_ms = device_ms(launch, 20), median_ms(launch, 20)
    p_ms = median_ms(lambda: binning.expand_entries_plain(*args, packed=packed), 5)
    n, entries = counts.shape[0], int(counts.sum())
    k_bound = bound(expand_bytes(counts, max_dup, packed),
                    EXPAND_OPS_PER_SLOT * min(entries, max_dup))
    row = dict(name=name, route="cuda", source="relightable3dgaussians_w_torch/csrc/expand.cu",
               replaces="relightable3dgaussians_w_tpu/ops/pallas/expand.py:58",
               max_abs_err=0.0, ms=k_ms, event_ms=k_event_ms, plain_ms=p_ms,
               bound_ms=k_bound[0], bound_by=k_bound[1], library_ms=None)
    return row, {"inputs": label, "rows": n, "entries": entries, "max_dup": max_dup,
                 "overflow_budget": short, f"{key}_bitwise_equal": True, f"{key}_ms": k_ms,
                 f"{key}_event_ms": k_event_ms,
                 f"{key}_plain_ms": p_ms, f"{key}_bound_ms": k_bound[0]}


def hold_row_intervals(call, label):
    """Kernel I on the arguments a caller passed the row-interval wrapper
    (`preprocess.row_intervals`: a PreprocessOut and the opacities) against
    its plain version `row_intervals_plain` (whose float32 rows it writes as
    int32), bitwise on every row, with times and its byte bound: the kernels
    line's row and a record (keys "i_*")."""
    args, kwargs = call
    counts_k, packed_k = row_intervals_kernel.row_intervals(*args, **kwargs)
    counts_p, packed_p = preprocess.row_intervals_plain(*args, **kwargs)
    torch.cuda.synchronize()
    if not (torch.equal(counts_k, counts_p) and torch.equal(packed_k, packed_p.to(torch.int32))):
        raise AssertionError(f"{label}: row_intervals differs from its plain version")
    launch = lambda: row_intervals_kernel.row_intervals(*args, **kwargs)
    k_ms, k_event_ms = device_ms(launch, 20), median_ms(launch, 20)
    plain = lambda: preprocess.row_intervals_plain(*args, **kwargs)
    p_ms, p_device_ms = median_ms(plain, 5), device_ms(plain, 5)
    n = counts_k.shape[0]
    k_bound = bound(ROW_INTERVAL_BYTES * n, ROW_INTERVAL_OPS * n)
    row = dict(name="row_intervals", route="cuda",
               source="relightable3dgaussians_w_torch/csrc/row_intervals.cu",
               replaces="relightable3dgaussians_w_tpu/ops/preprocess.py:249",
               max_abs_err=0.0, ms=k_ms, event_ms=k_event_ms, plain_ms=p_ms,
               bound_ms=k_bound[0], bound_by=k_bound[1], library_ms=None)
    return row, {"inputs": label, "rows": n, "rows_with_entries": int((counts_k > 0).sum()),
                 "i_bitwise_equal": True, "i_ms": k_ms, "i_event_ms": k_event_ms,
                 "i_plain_ms": p_ms, "i_plain_device_ms": p_device_ms,
                 "i_bound_ms": k_bound[0]}


def train_kernels_phase(ts, dev):
    """Kernels A (the rect expansion the step's binning makes), B (C = 13), C,
    P and D on the first training step's inputs."""
    x = step_inputs(ts.state, ts.cam, ts.gt, ts.ones, ts.ones, 0, ts.mlp, ts.cfg, ts.rcfg,
                    ts.bg, dev)
    a_row, a_rec = hold_expansion(x["expand"], "training step")
    if a_row["name"] != "expand_entries":
        raise AssertionError("training step: the binning walked row intervals, not rects")
    table, record = hold_step_kernels(x, ts.rcfg, dev)
    return a_row, table, {"phase": "train_kernels", "frame": "yaw 0, 800x800, 13 channels, step 0",
                          "expand": a_rec, **record}


TRAIN_PATH = ("expand_entries", "composite_forward", "composite_backward", "segment_sum_rows",
              "permute_entries", "preprocess_forward", "preprocess_backward")
TRAINER_PATH = ("row_intervals", "expand_entries_intervals") + TRAIN_PATH[1:] + ("view_unpack",)


def params_finite(state):
    return all(bool(torch.isfinite(x).all()) for x in TS.tree_leaves(state.params))


# The port's profiler ranges of one training step: the top-level parts of the
# step, and inside them the rasterizer's stages and the two backward kernels'
# wrappers.
STEP_PARTS = ("train_step.to_device", "train_step.leaf_inputs", "train_step.render",
              "train_step.losses", "train_step.backward", "train_step.adam")
STEP_SUBRANGES = ("rasterize.preprocess", "rasterize.binning", "rasterize.gather",
                  "rasterize.composite", "composite_tiles.backward", "gather_rows.backward")


def stage_table(prof, reps):
    """{range: {"host_ms", "device_span_ms", "device_busy_ms"}} per step from
    the port's profiler ranges: the host time inside the range; on the device,
    the range's span (its first kernel's start to its last kernel's end) and the
    kernel time inside that span. The device runs one stream, so the kernels in
    a span are the range's. The backward's kernels run on autograd's device
    thread, outside its range on the calling thread: its span is the gap
    between the losses' span and Adam's."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    names = STEP_PARTS + STEP_SUBRANGES
    host, spans, kernels = {}, {}, []
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end)
        if e.name in names:
            (host if e.device_type == cpu else spans).setdefault(e.name, []).append(r)
        elif e.device_type == cuda and not getattr(e, "is_user_annotation", False):
            kernels.append(r)
    missing = [k for k in names if len(host.get(k, ())) != reps]
    if missing:
        raise AssertionError(f"profiled steps lack the ranges {missing}")
    spans = {k: sorted(v) for k, v in spans.items()}
    spans["train_step.backward"] = [
        (lo[1], hi[0]) for lo, hi in zip(spans.get("train_step.losses", []),
                                         spans.get("train_step.adam", []))]
    busy = lambda w: sum(max(0.0, min(e, w[1]) - max(s, w[0])) for s, e in kernels)
    table = {}
    for k in names:
        w = spans.get(k, [])
        table[k] = {"host_ms": sum(e - s for s, e in host[k]) / 1e3 / reps,
                    "device_span_ms": sum(e - s for s, e in w) / 1e3 / reps,
                    "device_busy_ms": sum(busy(x) for x in w) / 1e3 / reps}
    return table


def profile_steps(step, state, reps):
    """`reps` calls state = step(state), back to back under torch.profiler:
    the stage table of the port's ranges per step, the host wall and the
    device busy ms per step, the idle share and the largest device kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state = step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    dev_events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3 / reps
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:10]
    return {"profiled_stages_per_step": stage_table(prof, reps),
            "profiled_step_wall_ms": wall_ms, "profiled_device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_per_step": sum(e.count for e in dev_events) / reps,
            "top_device_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / reps
                                       for e in top}}


def step_times(step, state, n):
    """ms of each of `n` calls state = step(state) on the card's stream, from a
    CUDA event recorded before each call to the next one (the last closed by
    an event after it), with no sync between the calls."""
    marks = []
    for _ in range(n + 1):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        if len(marks) <= n:
            state = step(state)
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])], state


def train_phase(ts, dev):
    """TRAIN_STEPS steps through train_step (the training path), a profiled
    window of 3 more, then the descent check on fixed draws."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state, losses, times = ts.state, [], []
    reset_launches()
    for i in range(TRAIN_STEPS):
        before = launch_counts()
        draws = TS.make_draws(ts.gen, ts.mlp, ts.cfg)
        s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_ev.record()
        state, aux = TS.train_step(state, *ts.args(draws), device=dev)
        e_ev.record()
        torch.cuda.synchronize()
        times.append(s_ev.elapsed_time(e_ev))
        losses.append(float(aux.loss))
        after = launch_counts()
        missing = [k for k in TRAIN_PATH if after[k] - before[k] < 1]
        if missing:
            raise AssertionError(f"train step {i}: no launch of {missing}")
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"train step {i}: loss {losses[-1]}")
        if int(aux.overflow) != 0:
            raise AssertionError(f"train step {i}: entry overflow {int(aux.overflow)}")
        if not params_finite(state):
            raise AssertionError(f"train step {i}: non-finite parameters")
        if not bool((state.gauss_state.xyz_grad_accum[aux.visibility] > 0).any()):
            raise AssertionError(f"train step {i}: no densification statistic on visible rows")
    launches = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20

    # Stage breakdown and device busy share of whole steps, back to back.
    draws = iter([TS.make_draws(ts.gen, ts.mlp, ts.cfg) for _ in range(3)])
    prof = profile_steps(lambda st: TS.train_step(st, *ts.args(next(draws)), device=dev)[0],
                         state, 3)

    # Descent at full width: from the starting state, TRAIN_STEPS steps that
    # all reuse one set of draws, so the loss differs between steps only by
    # the parameters.
    fixed = TS.make_draws(torch.Generator(device=dev).manual_seed(1), ts.mlp, ts.cfg)
    state, fixed_losses = ts.state, []
    for _ in range(TRAIN_STEPS + 1):   # the last call reads the loss after TRAIN_STEPS updates
        state, aux = TS.train_step(state, *ts.args(fixed), device=dev)
        fixed_losses.append(float(aux.loss))
    if not fixed_losses[-1] < fixed_losses[0]:
        raise AssertionError(f"loss on fixed draws did not fall: {fixed_losses}")

    record = {"phase": "train", "steps": TRAIN_STEPS, "resolution": [RES, RES],
              "gaussians": N_GAUSS + N_SKY, "channels": 13, "max_dup": ts.rcfg.max_dup,
              "target": "port render under embedding 1; sky and occluder masks all ones",
              "losses": losses, "step_ms": times,
              "ms_per_step_median_2_to_6": float(np.median(times[1:])),
              "launches": launches, "peak_memory_mb": peak_mb, **prof,
              # The profiler slows the host's dispatch; against the unprofiled
              # step time (CUDA events) the same device work leaves less idle.
              "device_idle_share_of_unprofiled_step":
                  1.0 - prof["profiled_device_busy_ms"] / float(np.median(times[1:])),
              "fixed_draw_losses": fixed_losses}
    return launches, record


def intervals_phase(host, dev):
    """Row intervals at full width, yaw 0: the scene as is and with
    scales[:, 0] *= ANISO. Per scene the rect and interval entry counts,
    kernels I (the row-interval pass) and A-int against their plain versions
    (bitwise) with times and bounds (the kernels line takes them at the
    trainer's shapes, `trainer_phase`), and
    a render plus one backward with intervals on and off, bitwise equal (the
    deltas against the JAX test's gates, 2e-6 on the image and 5e-4 of the
    largest gradient, are recorded beside)."""
    gx = host.rcfg.grid_x
    out = {}
    for label, stretch in (("isotropic", 1.0), (f"aniso_{ANISO:g}", ANISO)):
        cam, xyz, scl, quat, opa, rgb = frame_inputs(host, 0.0, dev)
        scl = scl * torch.tensor([stretch, 1.0, 1.0], device=dev)
        with torch.no_grad():
            pre = preprocess.preprocess(xyz, scl, quat, cam.viewmat, cam.projmat, cam.tan_fovx,
                                        cam.tan_fovy, RES, RES, 16,
                                        active=host.state.gauss_state.alive, opacities=opa)
        _, i_rec = hold_row_intervals(((pre, opa), {}), label)
        with torch.no_grad():
            counts, packed = preprocess.row_intervals(pre, opa)
        rect_n, iv_n = int(pre.tiles_touched.sum()), int(counts.sum())
        max_dup = ((int(rect_n * 1.05) + 4095) // 4096) * 4096
        _, a_int = hold_expansion((expand_args(pre, counts, gx, max_dup), {"packed": packed}),
                                  label)

        # Render + one backward with row intervals on and off.
        wimg = torch.randn((RES, RES, 3), generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        res = {}
        for flag in (False, True):
            rcfg = host.rcfg._replace(max_dup=max_dup, row_intervals=flag)
            leaves = [t.detach().clone().requires_grad_(True) for t in (xyz, scl, quat, opa, rgb)]
            img, aux = rasterize.rasterize(*leaves, host.bg_color, cam, rcfg,
                                           active=host.state.gauss_state.alive, device=dev)
            if int(aux.overflow) != 0:
                raise AssertionError(f"{label}: entry overflow {int(aux.overflow)}")
            (torch.sum(img * wimg) + torch.sum(aux.alpha)).backward()
            res[flag] = (img.detach(), aux.alpha.detach(), [t.grad for t in leaves],
                         int(aux.num_entries))
        img_d = float((res[True][0] - res[False][0]).abs().max())
        alpha_d = float((res[True][1] - res[False][1]).abs().max())
        grad_rel = {}
        for name, g0, g1 in zip(("means3d", "scales", "quats", "opacities", "colors"),
                                res[False][2], res[True][2]):
            grad_rel[name] = float((g1 - g0).abs().max() / g0.abs().max().clamp_min(1e-30))
        # The entries intervals drop are skipped by every pixel: the same bits.
        image_equal = torch.equal(res[True][0], res[False][0]) and \
            torch.equal(res[True][1], res[False][1])
        grads_equal = all(torch.equal(a, b) for a, b in zip(res[False][2], res[True][2]))
        if not (image_equal and grads_equal):
            raise AssertionError(f"{label}: intervals change the render: image {img_d:.3e}, "
                                 f"alpha {alpha_d:.3e}, gradients {grad_rel}")
        if res[True][3] != iv_n or res[False][3] != rect_n:
            raise AssertionError(f"{label}: rasterizer entry counts differ from preprocess's")
        out[label] = {
            "rect_entries": rect_n, "interval_entries": iv_n, "cut": 1.0 - iv_n / rect_n,
            "max_dup": max_dup, **{k: a_int[k] for k in ("a_int_bitwise_equal", "a_int_ms",
                                                         "a_int_plain_ms", "a_int_bound_ms")},
            **{k: i_rec[k] for k in ("i_bitwise_equal", "i_ms", "i_plain_ms", "i_plain_device_ms",
                                     "i_bound_ms", "rows_with_entries")},
            "image_max_abs_delta": img_d, "alpha_max_abs_delta": alpha_d,
            "grad_max_rel_delta": grad_rel,
            "image_bitwise_equal": True, "grads_bitwise_equal": True}
    return {"phase": "intervals", "frame": "yaw 0, 800x800", "gaussians": N_GAUSS + N_SKY, **out}


def orbit_view(deg):
    """World -> view of a camera yawed by `deg` around ORBIT_CENTER, at the
    origin for 0 degrees (the other phases' camera)."""
    rot = yaw(deg)[:3, :3]
    center = ORBIT_CENTER - ORBIT_CENTER[2] * rot[2]   # rot[2]: the viewing direction
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ center
    return view


def write_dataset(host, root: Path, dev, views=None, nerfosr=False):
    """A COLMAP-layout scene (sparse/0 text model + points3D.ply + images/) of
    `views` = [(image name, yaw in degrees, embedding index)], 800x800, each
    the port's render of the scene under that embedding; by default
    TRAINER_VIEWS views "view_NN" on the orbit, yaw -10..10 degrees, under
    embedding 0. The point cloud is the scene's foreground points. With
    `nerfosr` the images are also listed in train/rgb (the NeRF-OSR layout)."""
    from PIL import Image

    if views is None:
        views = [(f"view_{i:02d}", -10.0 + 20.0 * i / (TRAINER_VIEWS - 1), 0)
                 for i in range(TRAINER_VIEWS)]
    (root / "sparse" / "0").mkdir(parents=True)
    (root / "images").mkdir()
    if nerfosr:
        (root / "train" / "rgb").mkdir(parents=True)
    m = host.cfg.model
    focal = RES / (2.0 * float(np.tan(np.deg2rad(60.0) / 2)))
    lines = []
    with torch.inference_mode():
        xyz, scl, quat = (G.get_xyz(host.state.gaussians, host.state.gauss_state),
                          G.get_scaling(host.state.gaussians),
                          G.get_rotation(host.state.gaussians))
        opa = G.get_opacity(host.state.gaussians, host.state.gauss_state)[:, 0]
        for i, (stem, deg, e) in enumerate(views):
            envl, sky = host.mlp(host.state.embeddings[e][None])
            view = orbit_view(deg)
            cam = synthetic.camera(RES, RES, viewmat=view, device=dev)
            pre = preprocess.preprocess(xyz, scl, quat, cam.viewmat, cam.projmat, cam.tan_fovx,
                                        cam.tan_fovy, RES, RES, 16,
                                        active=host.state.gauss_state.alive, opacities=opa)
            demand = int(pre.tiles_touched.sum())
            rcfg = host.rcfg._replace(max_dup=((int(demand * 1.05) + 4095) // 4096) * 4096)
            img, aux = render_rgb(host.state.gaussians, host.state.gauss_state, envl[0], sky,
                                  cam, rcfg, host.bg_color, m.envlight_sh_degree,
                                  m.sky_sh_degree, m.specular, m.fix_sky, device=dev)
            if int(aux.overflow) != 0:
                raise AssertionError(f"dataset view {i}: entry overflow")
            u8 = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
            name = f"{stem}.png"
            Image.fromarray(u8).save(root / "images" / name)
            if nerfosr:
                shutil.copyfile(root / "images" / name, root / "train" / "rgb" / name)
            a = np.deg2rad(deg)   # the view rotation is a yaw: q = (cos a/2, 0, sin a/2, 0)
            t = view[:3, 3]
            lines += [f"{i + 1} {np.cos(a / 2):.17g} 0 {np.sin(a / 2):.17g} 0 "
                      f"{t[0]:.17g} {t[1]:.17g} {t[2]:.17g} 1 {name}", ""]
    (root / "sparse" / "0" / "images.txt").write_text("\n".join(lines) + "\n")
    (root / "sparse" / "0" / "cameras.txt").write_text(
        f"1 PINHOLE {RES} {RES} {focal:.17g} {focal:.17g} {RES / 2} {RES / 2}\n")
    pts = host.state.gaussians.xyz[:N_GAUSS].cpu().numpy()
    zeros, gray = np.zeros(N_GAUSS, np.float32), np.full(N_GAUSS, 128.0, np.float32)
    write_ply(str(root / "sparse" / "0" / "points3D.ply"),
              {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2], "nx": zeros, "ny": zeros,
               "nz": zeros, "red": gray, "green": gray, "blue": gray})


class StepRecorder:
    """Stands in for `train_step.train_step` while the trainer runs: a CUDA
    event before each step, and the step's loss and overflow kept on the
    device and read after the run, so the loop runs as a user's does (the
    default log cadence, no pull of its own)."""

    def __init__(self):
        self.inner, self.marks, self.out = TS.train_step, [], []

    def __call__(self, *args, **kwargs):
        self.marks.append(torch.cuda.Event(enable_timing=True))
        self.marks[-1].record()
        state, aux = self.inner(*args, **kwargs)
        self.out.append((aux.loss, aux.overflow))
        return state, aux


def trainer_phase(host, dev):
    """The trainer through `cli.train.main` on a COLMAP dataset of the scene:
    default settings (pool headroom 8, demand-sized budget, the probe, the loss
    logged every 100 iterations) plus runtime.row_intervals=true and
    TRAINER_SCHEDULE. Then, on the trained state and view 0: kernels I, A-int,
    B (C = 13), C, P and D against their plain versions at the shapes the
    trainer gives them, the two reloads, and steps with row intervals on (kernel
    I, and the eager plain pass in its place) and off."""
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    write_dataset(host, SCENE_DIR, dev)
    dataset_s = time.perf_counter() - t0
    out = WORK_DIR / "out"
    argv = [f"dataset.source_path={SCENE_DIR}", f"dataset.model_path={out}",
            f"optimizer.iterations={TRAINER_ITERS}", "runtime.max_dup=0",
            "runtime.row_intervals=true", *TRAINER_SCHEDULE, f"--device={dev.type}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    recorder = TS.train_step = StepRecorder()
    t0 = time.perf_counter()
    try:
        tr = cli_train.main(argv)
    finally:
        TS.train_step = recorder.inner
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20

    recs = [json.loads(line) for line in open(tr.log_path)]
    logged = [r for r in recs if "loss" in r]
    events = [r for r in recs if "event" in r]
    losses = [float(loss) for loss, _ in recorder.out]
    overflow = [int(n) for _, n in recorder.out]
    if (len(losses) != TRAINER_ITERS or not logged
            or not np.isfinite(losses + [r["loss"] for r in logged]).all()):
        raise AssertionError(f"trainer: {len(losses)} steps, losses {losses}, logged {logged}")
    overflowed = [it for it, n in enumerate(overflow, 1) if n > 0]
    healed = [r["iter"] for r in events if r["event"] == "heal_binning_overflow"]
    if healed != overflowed or any(it + 1 in overflowed for it in overflowed):
        raise AssertionError(f"trainer: overflow at {overflowed}, healed at {healed}")
    missing = [k for k in TRAINER_PATH if launches[k] < 1]
    if missing:
        raise AssertionError(f"trainer: no launch of {missing}")
    if launches["view_unpack"] < TRAINER_ITERS:   # each iteration's view is V's canvas
        raise AssertionError(f"trainer: {launches['view_unpack']} launches of V in "
                             f"{TRAINER_ITERS} iterations")
    dens = [r for r in events if r["event"] == "densify"]
    if {r["variant"] for r in dens} != {"plain", "sized"}:
        raise AssertionError(f"trainer: densify rounds {dens}")
    if sum(r["n_cloned"] + r["n_split"] for r in dens) == 0:
        raise AssertionError(f"trainer: densify selected nothing: {dens}")
    if not any(r["event"] == "opacity_reset" for r in events):
        raise AssertionError("trainer: no opacity reset")
    if not params_finite(tr.state):
        raise AssertionError("trainer: non-finite parameters after the run")
    it = TRAINER_ITERS
    for rel in (f"point_cloud/iteration_{it}/point_cloud.ply",
                f"checkpoint_embeddings/iteration_{it}/embeddings_weights.npz",
                f"checkpoint_MLP/iteration_{it}/MLP_weights.npz",
                f"envlights_sh/iteration_{it}/envlight_sh_view_00.npy",
                f"full_state/iteration_{it}/state.npz", "cameras.json", "cfg_args"):
        if not (out / rel).exists():
            raise AssertionError(f"trainer: checkpoint file {rel} missing")

    # Iteration i's time: from the event before its step to the event before
    # the next one. Quiet iterations have no host sync (a schedule event or a
    # logged loss) in them or just before them.
    iter_ms = [a.elapsed_time(b) for a, b in zip(recorder.marks, recorder.marks[1:])]
    syncs = {r["iter"] for r in events + logged}
    quiet = [ms for i, ms in enumerate(iter_ms, 1)
             if i > 1 and i not in syncs and i - 1 not in syncs]

    # The kernels on the trained state and view 0, at the shapes the trainer's
    # step gives them: A-int on the arguments the binning passed it.
    view = tr.train_views[0]
    vargs = (view["mats"], view["image_t"], view["sky_t"], view["occ_t"], view["cam"].uid)
    x = step_inputs(tr.state, *vargs, tr.mlp, tr.cfg, tr.rcfg, tr.bg_color, dev)
    a_int_row, a_int = hold_expansion(x["expand"], "trainer")
    if a_int_row["name"] != "expand_entries_intervals" or x["intervals"] is None:
        raise AssertionError("trainer: the binning walked rects, not row intervals")
    i_row, i_rec = hold_row_intervals(x["intervals"], "trainer")
    step_rows, step_rec = hold_step_kernels(x, tr.rcfg, dev)
    del x

    # Reload: the full-state bundle and the PLY warm start must render view 0
    # as the in-memory state does.
    emb = lambda: tr.state.params["embeddings"][0][None]
    with torch.no_grad():
        ref = tr._render_view(view, emb()).render
        st = tr.state
        t0 = time.perf_counter()
        tr.load_full_state(it)
        torch.cuda.synchronize()
        load_full_s = time.perf_counter() - t0
        img_full = tr._render_view(view, emb()).render
        full_dir = out / "full_state"
        full_dir.rename(out / "full_state_kept")
        try:
            t0 = time.perf_counter()
            tr.load_checkpoint(it)
            torch.cuda.synchronize()
            load_ply_s = time.perf_counter() - t0
        finally:
            (out / "full_state_kept").rename(full_dir)
        img_ply = tr._render_view(view, emb()).render
    if not torch.equal(img_full, ref):
        raise AssertionError("trainer: the full-state reload renders differently")
    ply_err = check_image(img_ply, ref, "trainer: the PLY reload's render")
    tr.state = st

    # Steps of the trained state on view 0 through the train_step the loop
    # calls, with row intervals on (as trained: kernel I, then with the eager
    # plain pass in its place) and off (the rects, the budget
    # sized from the probe's rect demand): 6 timed with CUDA events and no
    # sync between them, then 3 profiled (the port's profiler ranges).
    rect_demand, iv_demand = tr.init_report["rect_demand"], tr.init_report["interval_demand"]
    rect_rcfg = tr.rcfg._replace(
        row_intervals=False, max_dup=size_entry_budget(0, False, False, rect_demand, iv_demand)[1])
    modes = {}
    for mode, rcfg, pass_ in (("row_intervals_on", tr.rcfg, row_intervals_kernel.row_intervals),
                              ("row_intervals_on_eager_pass", tr.rcfg, eager_row_intervals),
                              ("row_intervals_off", rect_rcfg, None)):
        over = []

        def step(state, rcfg=rcfg, over=over):
            state, aux = TS.train_step(state, *vargs, TS.make_draws(tr.gen, tr.mlp, tr.cfg),
                                       tr.bg_color, tr.mlp, tr.cfg, rcfg, device=dev)
            over.append(aux.overflow)
            return state

        inner = row_intervals_kernel.row_intervals
        row_intervals_kernel.row_intervals = pass_ or inner
        try:
            times, tr.state = step_times(step, tr.state, 6)
            modes[mode] = {"max_dup": rcfg.max_dup, "step_ms": times,
                           "ms_per_step_median_2_to_6": float(np.median(times[1:])),
                           **profile_steps(step, tr.state, 3),
                           "overflow": max(int(n) for n in over)}
        finally:
            row_intervals_kernel.row_intervals = inner

    record = {"phase": "trainer", "views": TRAINER_VIEWS, "resolution": [RES, RES],
              "iterations": TRAINER_ITERS, "argv": argv, "dataset_write_s": dataset_s,
              "densify_grad_threshold": tr.cfg.optimizer.densify_grad_threshold,
              "init": tr.init_report,
              "interval_cut_at_init": 1.0 - iv_demand / rect_demand,
              "auto_decision": "on" if size_entry_budget(
                  0, False, True, rect_demand, iv_demand)[0] else "off",
              "final_max_dup": tr.rcfg.max_dup,
              "final_capacity": int(tr.state.gauss_state.alive.shape[0]),
              "final_alive": int(tr.state.gauss_state.alive.sum()),
              "launches": launches, "train_call_s": train_s, "peak_memory_mb": peak_mb,
              "iteration_time": "CUDA events between the loop's steps, default log cadence",
              "ms_per_iteration_median_quiet": float(np.median(quiet)),
              "quiet_iterations": len(quiet), "iteration_ms": iter_ms,
              "losses": losses, "logged_iterations": [r["iter"] for r in logged],
              "overflowed_steps": overflowed,
              "densify": dens, "densify_ms": [r["ms"] for r in dens],
              **{f"{name}_ms": [r["ms"] for r in events if r["event"] == name]
                 for name in ("opacity_reset", "grow_pool", "evaluate", "save")},
              "load_full_state_s": load_full_s, "load_checkpoint_ply_s": load_ply_s,
              "reload_full_state_render": "bitwise equal",
              "reload_ply_render_max_abs_err": ply_err[0],
              "reload_ply_render_bitwise_equal": bool(torch.equal(img_ply, ref)),
              "kernels_at_trainer_shapes": {"row_intervals": i_rec,
                                            "expand_entries_intervals": a_int, **step_rec},
              **modes}
    return launches, a_int_row, i_row, step_rows, record


class ForwardRecorder:
    """Stands in for `composite_kernel.composite_forward` during the eval phase:
    counts the calls by channel count (each call launches kernel B once) and
    keeps the inputs of the first call of each channel count in `keep`."""

    def __init__(self, keep):
        self.inner, self.keep = composite_kernel.composite_forward, keep
        self.calls, self.kept = collections.Counter(), {}

    def __call__(self, feat, tile_start, tile_end, bg, grid_x, grid_y, tile=16):
        C = feat.shape[1] - 6
        self.calls[C] += 1
        if C in self.keep and C not in self.kept:
            self.kept[C] = (feat, tile_start, tile_end, bg, grid_x, grid_y)
        return self.inner(feat, tile_start, tile_end, bg, grid_x, grid_y, tile)


class BinningRecorder:
    """Stands in for the rasterizer's `bin_gaussians`: keeps each render's entry
    overflow on the device, labelled with the running stage."""

    def __init__(self, stage):
        self.inner, self.stage, self.out = rasterize.bin_gaussians, stage, []

    def __call__(self, *args, **kwargs):
        b = self.inner(*args, **kwargs)
        self.out.append((self.stage[0], b.overflow))
        return b


@contextlib.contextmanager
def timed_stages(stages, times, stage):
    """Time each CLI's `main` (name -> module) while it runs, and name the running
    stage in stage[0]."""
    mains = {name: mod.main for name, mod in stages.items()}

    def timed(name, fn):
        def run(argv=None):
            stage[0] = name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(argv)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            return out
        return run

    try:
        for name, mod in stages.items():
            mod.main = timed(name, mains[name])
        yield
    finally:
        for name, mod in stages.items():
            mod.main = mains[name]


def write_eval_inputs(data_root: Path):
    """A 256x512 equirect envmap (dim noise and one sun, from RandomState(0)),
    a 1000x1000 evaluation mask and the test config of view_00 (the view that
    dataset.eval=true holds out)."""
    from PIL import Image

    rng = np.random.RandomState(0)
    env = rng.uniform(0.02, 0.15, (256, 512, 3))
    yy, xx = np.mgrid[:256, :512]
    sun_y, sun_x = rng.randint(20, 90), rng.randint(0, 512)
    env[np.hypot(yy - sun_y, xx - sun_x) < 12] = 1.0
    env_path = data_root / "envmap_view_00.png"
    Image.fromarray((env * 255).astype(np.uint8)).save(env_path)
    mask = np.zeros((1000, 1000), np.uint8)
    mask[60:940, 40:960] = 255
    my, mx = np.mgrid[:1000, :1000]
    mask[np.hypot(my - 500, mx - 620) < 90] = 0        # an occluder
    mask_path = data_root / "mask_view_00.png"
    Image.fromarray(mask).save(mask_path)
    tc = data_root / "test_configs" / SCENE
    tc.mkdir(parents=True, exist_ok=True)
    (tc / "test_config.json").write_text(json.dumps({"view_00": {
        "env_map_path": str(env_path), "mask_path": str(mask_path),
        "initial_env_map_rotation": {"x": 0.0, "y": 0.0, "z": 0.0}, "sun_angles": [0, 360],
        "env_map_scaling": {"threshold": 0.999, "scale": 10}}}))
    return env_path


def hold_forward(call, label, plain_iters=3):
    """Kernel B on one call's inputs against its plain version (image tolerance
    on the tiles), with times (the plain version's over `plain_iters` calls)
    and bound: (row fields, record, kernel output)."""
    feat, ts_, te_, bg, gx, gy = call
    C = feat.shape[1] - 6
    out_k = composite_kernel.composite_forward(feat, ts_, te_, bg, gx, gy)
    out_p = composite.composite_forward(feat, ts_, te_, bg, gx, gy)
    torch.cuda.synchronize()
    if not torch.isfinite(out_k[0]).all():
        raise AssertionError(f"{label}: non-finite values")
    err = check_image(out_k[0], out_p[0], f"{label} image")
    tfin_err = check_image(out_k[1], out_p[1], f"{label} final transmittance")
    k_ms = median_ms(lambda: composite_kernel.composite_forward(feat, ts_, te_, bg, gx, gy), 20)
    p_ms = median_ms(lambda: composite.composite_forward(feat, ts_, te_, bg, gx, gy),
                     plain_iters)
    entries = int((te_ - ts_).sum())
    pairs = pair_counts(feat, ts_, te_, gx)
    T, P = gx * gy, 256
    b_bound = bound(pairs["entries_read"] * feat.shape[1] * 4 + T * 2 * 8 + C * 4
                    + T * P * (C + 1) * 4,
                    compositor_ops(composite_ops_per_pair(C), pairs))
    row = dict(max_abs_err=err[0], ms=k_ms, plain_ms=p_ms, bound_ms=b_bound[0],
               bound_by=b_bound[1], library_ms=None)
    return row, {"channels": C, "entries": entries, "pairs": pairs, "image_max_abs_err": err[0],
                 "image_frac_over_1e-3": err[1], "image_median_err": err[2],
                 "tfin_max_abs_err": tfin_err[0], "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": b_bound[0]}, out_k


def eval_phase(dev):
    """The evaluation / relighting path at full width: `cli.full_eval.main` on the
    trainer phase's dataset with a GT envmap for the held-out view, then the
    white-light and relighting CLIs on the same checkpoint."""
    data_root = SCENE_DIR.parent
    env_path = write_eval_inputs(data_root)
    out = WORK_DIR / "eval"
    mp = out / SCENE
    overrides = [f"optimizer.iterations={EVAL_ITERS}", "runtime.max_dup=0"]
    common = [f"dataset.source_path={SCENE_DIR}", f"dataset.model_path={mp}",
              "dataset.eval=true", *overrides, f"model.load_iteration={EVAL_ITERS}"]
    stages = {"train": cli_train, "render": cli_render, "metrics": cli_metrics,
              "gt_envmap": cli_eval_gt, "white_light": cli_white, "relit": cli_relit}
    times, stage = {}, ["setup"]
    reset_launches()
    fwd, bins = ForwardRecorder(keep=(21, 51)), BinningRecorder(stage)
    composite_kernel.composite_forward, rasterize.bin_gaussians = fwd, bins
    try:
        with timed_stages(stages, times, stage):
            cli_full_eval.main([f"--data_root={data_root}", f"--output={out}",
                                f"--scenes={SCENE}", *overrides])
            cli_white.main(common)
            cli_relit.main(common + [f"--envmap={env_path}", f"--steps={RELIT_STEPS}"])
    finally:
        composite_kernel.composite_forward, rasterize.bin_gaussians = fwd.inner, bins.inner
    launches = launch_counts()
    by_c = dict(fwd.calls)
    if sum(by_c.values()) != launches["composite_forward"]:
        raise AssertionError(f"eval: {launches['composite_forward']} B launches for {by_c} calls")
    missing = [k for k, n in (("B at C = 13", by_c.get(13, 0)), ("B at C = 21", by_c.get(21, 0)),
                              ("B at C = 51", by_c.get(51, 0)),
                              ("C", launches["composite_backward"]),
                              ("D", launches["segment_sum_rows"]),
                              ("P", launches["permute_entries"]),
                              ("A", launches["expand_entries"]
                               + launches["expand_entries_intervals"])) if n < 1]
    if missing:
        raise AssertionError(f"eval: no launch of {missing}")
    overflow = collections.Counter()
    for name, o in bins.out:
        overflow[name] += int(o)
    if any(n for name, n in overflow.items() if name != "train"):
        raise AssertionError(f"eval: entry overflow in renders after training: {overflow}")

    # Artifacts and metrics.
    it = f"iteration_{EVAL_ITERS}"
    trains = [f"view_{i:02d}" for i in range(1, TRAINER_VIEWS)]
    for split, names in (("train", trains), ("test", ["view_00"])):
        for aov in cli_render.AOV_DIRS:
            ext = [".npy", ".jpg"] if aov.startswith("rendered_") else [".png"]
            have = set(os.listdir(mp / split / it / aov))
            if not {n + e for n in names for e in ext} <= have:
                raise AssertionError(f"eval: {split}/{aov} lacks renders: {sorted(have)}")
    results = json.loads((mp / "results.json").read_text())
    if set(results) != {f"train/{it}", f"test/{it}"} or not all(
            np.isfinite([r[k] for k in ("psnr", "ssim", "mse")]).all() and r["lpips"] is None
            for r in results.values()):
        raise AssertionError(f"eval: metrics {results}")
    relit_lines = (mp / "relit_gt_envmaps" / it / "metrics.txt").read_text().splitlines()
    gt_psnr = float(relit_lines[0].split("PSNR ")[1].split()[0])
    best_angle = float(relit_lines[0].split("best_angle ")[1])
    white = json.loads((mp / "white_light" / it / "results.json").read_text())
    frames = sorted(os.listdir(mp / "relit_novel_view" / it))
    halffit = [r["test_psnr_halffit"] for r in map(json.loads, open(mp / "train_log.jsonl"))
               if "test_psnr_halffit" in r]
    if not (np.isfinite(gt_psnr) and (mp / "relit_gt_envmaps" / it / "view_00.png").exists()
            and np.isfinite([v["psnr"] for v in white.values()]).all() and white
            and len([f for f in frames if f.startswith("frame_")]) == RELIT_STEPS
            and len(halffit) == 1 and np.isfinite(halffit[0])):
        raise AssertionError(f"eval: gt-envmap {relit_lines}, white light {white}, relit frames "
                             f"{frames}, half-fit {halffit}")

    rows, kernel_records = {}, {}
    for C, label in ((21, "render: the first train view, 21 channels"),
                     (51, "GT-envmap sweep: the first group of 17 angles, 51 channels")):
        rows[C], kernel_records[C], _ = hold_forward(fwd.kept.pop(C), label)
        kernel_records[C]["inputs"] = label
    record = {"phase": "eval", "views": TRAINER_VIEWS, "test_views": ["view_00"],
              "resolution": [RES, RES], "train_iterations": EVAL_ITERS,
              "relit_steps": RELIT_STEPS, "overrides": overrides, "stage_s": times,
              "launches": launches, "composite_forward_calls_by_channels": by_c,
              "overflow_by_stage": dict(overflow), "metrics": results,
              "gt_envmap_psnr": gt_psnr, "gt_envmap_best_angle": best_angle,
              "white_light": white, "test_psnr_halffit": halffit[0],
              "kernels": {f"composite_forward_c{C}": r for C, r in kernel_records.items()}}
    return launches, by_c, rows, record


def write_pretrain_dataset(host, dev):
    """The pretrain phase's NeRF-OSR-layout dataset: PRETRAIN_VIEWS views on
    the orbit (yaw -10..10 degrees), alternating between the two CONDITIONS,
    listed in train/rgb, and train/envmaps_init/<condition>.npy, the envlight
    SH of the condition's embedding. Returns its wall seconds."""
    t0 = time.perf_counter()
    views = []
    for i in range(PRETRAIN_VIEWS):
        _, fmt, e = CONDITIONS[i % len(CONDITIONS)]
        views.append((fmt.format(i), -10.0 + 20.0 * i / (PRETRAIN_VIEWS - 1), e))
    write_dataset(host, PRETRAIN_DIR, dev, views, nerfosr=True)
    prior_dir = PRETRAIN_DIR / "train" / "envmaps_init"
    prior_dir.mkdir()
    with torch.inference_mode():
        for cond, _, e in CONDITIONS:
            envl, _ = host.mlp(host.state.embeddings[e][None])
            np.save(prior_dir / f"{cond}.npy", envl[0].cpu().numpy())
    return time.perf_counter() - t0


class Timed:
    """Stands in for a function of `pretrain` while the train CLI runs: each
    call's wall seconds (device synced before and after), arguments and
    result."""

    def __init__(self, name):
        self.name, self.inner, self.calls = name, getattr(pretrain, name), []

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner(*args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append((time.perf_counter() - t0, args, out))
        return out


def embedding_net_check(dev, batch=4):
    """One full-width EmbeddingNet forward (reconstruction, batch statistics)
    and backward of the pretraining loss on `batch` 256x256 inputs, float32 on
    the card and on the CPU, and float64 on the card as the exact reference.
    The card's output must be within 1e-4 of the CPU's largest value. Each
    float32 gradient of the card must be within 5e-3 of the float64 one, or
    no farther from it than twice the CPU's float32 gradient: with random
    weights and inputs the decoder's Dense and a few convolutions have
    gradients that are sums which mostly cancel, and there the CPU's own
    float32 gradient is 1-6% off (H100, torch 2.11). The convolution biases
    in front of the batch norms have zero gradients up to rounding (the norm
    removes a per-channel shift): theirs must stay at rounding level."""
    gen = torch.Generator().manual_seed(0)
    cpu_net = EmbeddingNet(generator=gen)
    x = torch.rand((batch, 256, 256, 3), generator=gen)
    res = {}
    for name, d, dt in (("cpu", torch.device("cpu"), torch.float32), ("card", dev, torch.float32),
                        ("card64", dev, torch.float64)):
        net, xx = copy.deepcopy(cpu_net).to(d, dt), x.to(d, dt)
        with fp32_convs():
            recon = net(xx, pretraining=True, train=True)
            torch.mean((recon - xx) ** 2).backward()
        res[name] = (recon.detach().double().cpu(),
                     {k: p.grad.double().cpu() for k, p in net.named_parameters()})
    (ref, cpu_g), (got, card_g), (_, exact) = res["cpu"], res["card"], res["card64"]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    fwd_err = rel(got, ref)
    top = max(float(g.abs().max()) for g in exact.values())
    biases = {f"{m}.{i}.bias" for m in ("conv", "deconv") for i in range(4)}
    rows, bad = {}, {}
    for k, g in exact.items():
        if k in biases:
            rows[k] = {"over_max_grad": max(float(card_g[k].abs().max()),
                                            float(cpu_g[k].abs().max())) / top}
            ok = rows[k]["over_max_grad"] < 1e-4
        else:
            rows[k] = {"card_vs_cpu": rel(card_g[k], cpu_g[k]),
                       "card_vs_f64": rel(card_g[k], g), "cpu_vs_f64": rel(cpu_g[k], g)}
            r = rows[k]
            ok = r["card_vs_f64"] <= max(5e-3, 2 * r["cpu_vs_f64"])
        if not ok:
            bad[k] = rows[k]
    if not fwd_err < 1e-4 or bad:
        raise AssertionError(f"pretrain: EmbeddingNet card vs CPU: forward {fwd_err}, "
                             f"gradients {bad}")
    return {"batch": batch, "forward_max_rel_err": fwd_err, "gradients": rows}


def pretrain_phase(dev):
    """`cli.train.main` with model.init_embeddings=true model.init_sh_mlp=true on
    the pretrain dataset: the autoencoder (256x256 inputs, channels_f 128,
    latent 32, batch 32) for PRETRAIN_EPOCHS epochs, the encoding, the SH-MLP
    fit to the two priors (MLP 256/256/128, SH degrees 4 / 1), then
    PRETRAIN_ITERS trainer iterations; and the EmbeddingNet card-vs-CPU
    check."""
    timed = {n: Timed(n) for n in ("_load_resized_images", "pretrain_embedding_net",
                                   "encode_embeddings", "initialize_sh_mlp")}
    out = WORK_DIR / "pretrain"
    argv = [f"dataset.source_path={PRETRAIN_DIR}", f"dataset.model_path={out}",
            "model.init_embeddings=true", "model.init_sh_mlp=true",
            f"optimizer.embednet_pretrain_epochs={PRETRAIN_EPOCHS}",
            f"optimizer.iterations={PRETRAIN_ITERS}", "runtime.max_dup=0", f"--device={dev.type}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    steps = TS.train_step = StepRecorder()
    fwd = composite_kernel.composite_forward = ForwardRecorder(keep=())
    for name, t in timed.items():
        setattr(pretrain, name, t)
    t0 = time.perf_counter()
    try:
        tr = cli_train.main(argv)
    finally:
        TS.train_step, composite_kernel.composite_forward = steps.inner, fwd.inner
        for name, t in timed.items():
            setattr(pretrain, name, t.inner)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20

    (load_s, _, images), = timed["_load_resized_images"].calls
    (ae_s, _, (_, ae_losses)), = timed["pretrain_embedding_net"].calls
    (encode_s, _, emb), = timed["encode_embeddings"].calls
    (sh_s, (_, mlp, before, emb_in, names, priors), fitted), = timed["initialize_sh_mlp"].calls
    epoch_mse = [float(np.mean(e)) for e in ae_losses]
    if len(epoch_mse) != PRETRAIN_EPOCHS or not epoch_mse[-1] < epoch_mse[0]:
        raise AssertionError(f"pretrain: autoencoder epoch MSE {epoch_mse}")
    n_train = len(tr.train_views)
    norm_err = float((torch.linalg.vector_norm(emb, dim=-1) - 1).abs().max())
    if (images.shape != (PRETRAIN_VIEWS, 256, 256, 3) or tuple(emb.shape) != (n_train, 32)
            or not norm_err < 1e-5 or not torch.equal(emb_in, emb)):
        raise AssertionError(f"pretrain: images {images.shape}, embeddings {tuple(emb.shape)}, "
                             f"norm error {norm_err}")
    conds = [pretrain.lighting_condition_of(n) for n in names]
    matches = [[p for p in priors if c in p] for c in conds]
    if "" in conds or any(len(m) != 1 for m in matches) or len(set(conds)) != len(CONDITIONS):
        raise AssertionError(f"pretrain: conditions {sorted(set(conds))}, priors {list(priors)}")
    targets = torch.as_tensor(pretrain.sh_prior_targets(names, priors, mlp.sh_dim_envl),
                              device=dev)
    with torch.no_grad():
        mse = lambda p: float(torch.mean((functional_call(mlp, p, (emb_in,))[0] - targets) ** 2))
        sh_mse = {"before": mse(before), "after": mse(fitted)}
    if not sh_mse["after"] < sh_mse["before"]:
        raise AssertionError(f"pretrain: SH-MLP MSE against the priors {sh_mse}")
    losses = [float(loss) for loss, _ in steps.out]
    if len(losses) != PRETRAIN_ITERS or not np.isfinite(losses).all():
        raise AssertionError(f"pretrain: trainer losses {losses}")
    missing = [k for k in TRAIN_PATH[1:] if launches[k] < 1]
    if launches["expand_entries"] + launches["expand_entries_intervals"] < 1:
        missing.append("expand_entries")
    if missing or set(fwd.calls) != {13}:
        raise AssertionError(f"pretrain: no launch of {missing}; B by channels {fwd.calls}")
    iter_ms = [a.elapsed_time(b) for a, b in zip(steps.marks, steps.marks[1:])]
    return launches, {
        "phase": "pretrain", "views": n_train, "resolution": [RES, RES], "argv": argv,
        "conditions": sorted(set(conds)), "autoencoder": {
            "input": 256, "channels_f": 128, "latent": 32, "batch": 32,
            "epochs": PRETRAIN_EPOCHS, "epoch_mse": epoch_mse},
        "embedding_norm_max_err": norm_err, "sh_mlp_mse": sh_mse,
        "stage_s": {"image_load": load_s, "autoencoder": ae_s, "encode": encode_s,
                    "sh_mlp_init": sh_s, "cli_total": total_s},
        "ms_per_autoencoder_epoch": ae_s / PRETRAIN_EPOCHS * 1e3,
        "trainer_iterations": PRETRAIN_ITERS, "trainer_losses": losses,
        "trainer_iteration_ms": iter_ms,
        "ms_per_iteration_median_2_on": float(np.median(iter_ms[1:])),
        "launches": launches, "peak_memory_mb": peak_mb,
        "embedding_net_card_vs_cpu": embedding_net_check(dev)}


def rel_err(got, want):
    return float((got.double().cpu() - want.double().cpu()).abs().max()
                 / want.double().abs().max())


def smooth_sky(h, rng):
    """A [h, 2h, 3] equirect: a sky brightening towards the horizon, smooth
    clouds and a Gaussian sun of peak 50, from `rng`. It is smooth near the
    poles, as a sky is: there atan2 / acos, which the card and the CPU round
    differently in the last ulp, decide which pixels of the top rows a texel
    reads, and per-pixel noise there put ~3e-5 of the largest value between the
    card's cubemap and the CPU's (H100 against an x86 CPU, torch 2.11)."""
    yy, xx = np.mgrid[:h, :2 * h] / h
    sky = (0.2 + 0.6 * yy)[..., None] * np.array([0.5, 0.7, 1.0])
    for _ in range(6):
        cy, cx, r = rng.uniform(0.1, 0.5), rng.uniform(0, 2), rng.uniform(0.05, 0.2)
        sky += 0.3 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
    sun_y, sun_x = rng.uniform(0.15, 0.4), rng.uniform(0.2, 1.8)
    sky += 50.0 * np.exp(-((yy - sun_y) ** 2 + (xx - sun_x) ** 2) / (2 * 0.02 ** 2))[..., None]
    return sky.astype(np.float32)

def library_phase(pts, dev):
    """The library modules on the card at the scene's size: the Morton-order
    k-NN of the 1,000,000 foreground points against the host's exact 3-NN (and
    against the CPU on a 100,000-point subset), the point-light BSDF on 1.01M
    points (card against CPU), a seeded equirect written as Radiance .hdr,
    loaded into a cubemap and prefiltered at res 512 (card against CPU at 64),
    and split-sum shading of 1.01M points against it."""
    rec = {"phase": "library"}
    pts = pts.to(dev)
    approx = knn.knn_dist2_morton(pts)
    morton_ms = median_ms(lambda: knn.knn_dist2_morton(pts), 3)
    host_pts = pts.cpu().numpy()
    t0 = time.perf_counter()
    exact = knn.knn_dist2(host_pts)
    exact_ms = (time.perf_counter() - t0) * 1e3
    approx = approx.cpu().numpy()
    if not (np.isfinite(approx).all() and (approx > 0).all()):
        raise AssertionError("library: knn_dist2_morton gave non-finite or non-positive values")
    ratio = approx / exact
    sub = pts[:LIBRARY_KNN_SUBSET]
    card_sub, cpu_sub = knn.knn_dist2_morton(sub).cpu(), knn.knn_dist2_morton(sub.cpu())
    sub_err = float(((card_sub - cpu_sub).abs() / cpu_sub.abs()).max())
    if not sub_err <= 1e-6:
        raise AssertionError(f"library: knn_dist2_morton card vs CPU {sub_err}")
    rec["knn"] = {"points": len(host_pts), "morton_ms": morton_ms, "exact_host_ms": exact_ms,
                  "median_approx_over_exact": float(np.median(ratio)),
                  "share_within_2x": float(np.mean(ratio <= 2.0)),
                  "card_vs_cpu_subset_max_rel_err": sub_err, "subset": LIBRARY_KNN_SUBSET}

    # pbr_bsdf card against CPU, held on roughness in [0.5, 1]. Below that the
    # GGX peak turns a 1-ulp difference in a normalized half vector (CUDA's
    # rsqrtf is not correctly rounded) into up to ~6e-4 of the largest value
    # (ops/bsdf.py); the full-range number is recorded, not held.
    rng = np.random.RandomState(0)
    n = N_GAUSS + N_SKY
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    arm = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cpu_in = [torch.as_tensor(a) for a in (
        rng.uniform(0, 1, (n, 3)).astype(np.float32), arm,
        rng.normal(size=(n, 3)).astype(np.float32), nrm,
        np.array([0.3, 2.0, 4.0], np.float32), np.array([-2.0, 3.0, 1.0], np.float32))]
    dev_in = [a.to(dev) for a in cpu_in]
    held_arm = torch.as_tensor(arm * np.array([1.0, 0.5, 1.0], np.float32)
                               + np.array([0.0, 0.5, 0.0], np.float32))
    rec["pbr_bsdf"] = {"points": n, "held_roughness": [0.5, 1.0]}
    for mode in (0, 1):
        full = rel_err(bsdf.pbr_bsdf(*dev_in, bsdf=mode), bsdf.pbr_bsdf(*cpu_in, bsdf=mode))
        held_cpu = [cpu_in[0], held_arm, *cpu_in[2:]]
        err = rel_err(bsdf.pbr_bsdf(*[a.to(dev) for a in held_cpu], bsdf=mode),
                      bsdf.pbr_bsdf(*held_cpu, bsdf=mode))
        if not err < 1e-5:
            raise AssertionError(f"library: pbr_bsdf (bsdf={mode}) card vs CPU {err}")
        rec["pbr_bsdf"][f"bsdf_{mode}"] = {
            "max_rel_err": err, "full_range_max_rel_err": full,
            "ms": median_ms(lambda: bsdf.pbr_bsdf(*dev_in, bsdf=mode), 10)}

    env = smooth_sky(256, rng)
    path = WORK_DIR / "library" / "envmap.hdr"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_hdr(str(path), env)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = cube.load_hdr_cubemap(str(path), CUBEMAP_RES, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mips = cube.build_mips(base)
    torch.cuda.synchronize()
    mips_s = time.perf_counter() - t0
    levels = list(mips.specular) + [mips.diffuse]
    if not all(bool(torch.isfinite(m).all()) for m in levels):
        raise AssertionError("library: non-finite cubemap mips")
    small = {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        b = cube.load_hdr_cubemap(str(path), CUBEMAP_CHECK_RES, device=d)
        m = cube.build_mips(b)
        small[key] = [b, *m.specular, m.diffuse]
    check = [rel_err(a, b) for a, b in zip(small["card"], small["cpu"])]
    if not max(check) < 1e-5:
        raise AssertionError(f"library: cubemap card vs CPU at res {CUBEMAP_CHECK_RES}: {check}")
    ks = torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32), device=dev)
    shade = lambda: cube.shade_cubemap(mips, dev_in[2], dev_in[3], dev_in[0], ks, dev_in[4])
    shaded = shade()
    if not bool(torch.isfinite(shaded).all()):
        raise AssertionError("library: non-finite shade_cubemap output")
    rec["cubemap"] = {"hdr": [256, 512], "res": CUBEMAP_RES, "load_s": load_s,
                      "build_mips_s": mips_s, "levels": [int(m.shape[1]) for m in levels],
                      "card_vs_cpu_res": CUBEMAP_CHECK_RES, "card_vs_cpu_max_rel_err": check,
                      "shade_points": n, "shade_ms": median_ms(shade, 10)}
    return rec


# ------------------------------------------------------------------ parallel

# The training self-check at its defaults and gates (scripts/selfcheck_train.py),
# and the serving demo at its defaults (scripts/serve_demo.py).
SELFCHECK_ITERS, SELFCHECK_RES, SELFCHECK_VIEWS = 1500, 128, 8
SELFCHECK_CLI_ITERS = 200               # the CLI's run, gates at 0
SELFCHECK_DIR = WORK_DIR / "selfcheck"
DEMO_N, DEMO_RES, DEMO_FRAMES = 1_000_000, 800, 30
DEMO_DIR = WORK_DIR / "serve_demo"
MODULE_TIMEOUT_S = 600


def run_module(module, args, env=None):
    """`python -m module args` from the repository root, killed after
    MODULE_TIMEOUT_S. Returns (exit code, standard output, standard error)."""
    proc = subprocess.run([sys.executable, "-m", module, *args],
                          cwd=Path(__file__).resolve().parent,
                          env=dict(os.environ, **(env or {})), capture_output=True, text=True,
                          timeout=MODULE_TIMEOUT_S)
    return proc.returncode, proc.stdout, proc.stderr


def selfcheck_phase(dev):
    """The training self-check on the card at its defaults, once plain and once
    through the data-parallel step (NCCL at one rank), each held to its gates
    and to zero overflow; then the module's CLI as a subprocess with the gates
    at 0 (exit 0, its jsonl written)."""
    module = "relightable3dgaussians_w_torch.scripts.selfcheck_train"
    reset_launches()
    legs, failed = {}, []
    for dp in (False, True):
        t0 = time.perf_counter()
        setup = selfcheck_train.build_selfcheck(SELFCHECK_RES, SELFCHECK_VIEWS, dev,
                                                torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        backend = []
        log = lambda msg: backend.append(msg)
        run = selfcheck_train.run_selfcheck(setup, SELFCHECK_ITERS, dp=dp, log=log)
        g = selfcheck_train.gates(run.trajectory, SELFCHECK_ITERS)
        name = "dp" if dp else "plain"
        legs[name] = {"trajectory": run.trajectory, "first": g.first, "best": g.best,
                      "gain": g.best - g.first, "tail_mean": g.tail_mean, "gates_ok": g.ok,
                      "its_per_s": SELFCHECK_ITERS / run.seconds,
                      "ms_per_iter": run.seconds * 1e3 / SELFCHECK_ITERS,
                      "loop_s": run.seconds, "build_s": build_s, "overflow": run.overflow,
                      "alive_end": int(G.num_alive(run.state.gauss_state)),
                      "log": backend[0] if dp else None}
        if not g.ok or run.overflow:
            failed.append(f"{name}: best {g.best:.2f} (>= {g.min_psnr}), gain "
                          f"{g.best - g.first:.2f} (>= {g.min_gain}), tail mean "
                          f"{g.tail_mean:.2f} (>= {g.min_tail}), overflow {run.overflow}")
    launches = launch_counts()
    record = {"phase": "selfcheck", "iters": SELFCHECK_ITERS, "res": SELFCHECK_RES,
              "views": SELFCHECK_VIEWS, "legs": legs,
              "launches": {k: launches[k] for k in TRAIN_PATH}}
    if failed:
        emit(record)
        raise AssertionError("selfcheck gates failed: " + "; ".join(failed))
    if any(launches[k] < 1 for k in TRAIN_PATH) or launches["composite_forward_packed"] \
            or launches["expand_entries_intervals"]:
        raise AssertionError(f"selfcheck: kernel launches {launches}")

    SELFCHECK_DIR.mkdir(parents=True, exist_ok=True)
    out = SELFCHECK_DIR / "cli.jsonl"
    t0 = time.perf_counter()
    rc, log, err = run_module(module, [str(SELFCHECK_CLI_ITERS), str(SELFCHECK_RES),
                                       str(SELFCHECK_VIEWS), f"--out={out}"],
                              env={f"SELFCHECK_MIN_{k}": "0" for k in ("PSNR", "GAIN", "TAIL")})
    log += err
    cli_s = time.perf_counter() - t0
    summary = json.loads(out.read_text().splitlines()[-1]) if rc == 0 else None
    if rc != 0 or not summary["ok"] or summary["iters"] != SELFCHECK_CLI_ITERS \
            or not summary["device"].startswith("cuda"):
        raise AssertionError(f"selfcheck CLI: exit {rc}, summary {summary}:\n{log[-3000:]}")
    record["cli"] = {"iters": SELFCHECK_CLI_ITERS, "exit": rc, "wall_s": cli_s,
                     "first": summary["first"], "best": summary["best"],
                     "its_per_s": summary["its_per_s"]}
    return launches, record


def serve_demo_phase():
    """The serving demo's CLI as a subprocess at its defaults (DEMO_N Gaussians,
    DEMO_RES², DEMO_FRAMES frames), exact and then --packed: every frame
    served, zero overflow, and the served frames' launches (the demo's record)
    of A, P and B, or of B' and not B when packed."""
    DEMO_DIR.mkdir(parents=True, exist_ok=True)
    records, launches = {}, collections.Counter()
    for mode in ("exact", "packed"):
        out = DEMO_DIR / f"{mode}.json"
        t0 = time.perf_counter()
        rc, log, err = run_module("relightable3dgaussians_w_torch.scripts.serve_demo",
                                  [str(DEMO_N), str(DEMO_RES), str(DEMO_FRAMES), f"--out={out}"]
                                  + (["--packed"] if mode == "packed" else []))
        log += err
        if rc != 0:
            raise AssertionError(f"serve_demo {mode}: exit {rc}:\n{log[-3000:]}")
        rec = json.loads(out.read_text())
        n = rec["launches"]
        b, b_other = (("composite_forward_packed", "composite_forward") if mode == "packed"
                      else ("composite_forward", "composite_forward_packed"))
        if (rec["frames"] != DEMO_FRAMES or rec["max_overflow"] != 0
                or rec["packed_rgb"] != (mode == "packed") or n[b] < DEMO_FRAMES or n[b_other]
                or n["expand_entries"] < DEMO_FRAMES or n["permute_entries"] < DEMO_FRAMES):
            raise AssertionError(f"serve_demo {mode}: record {rec}")
        records[mode] = dict(rec, process_wall_s=time.perf_counter() - t0)
        launches.update(n)
    return dict(launches), {"phase": "serve_demo", **records}


# The data-parallel scaling harness (scripts/bench_scaling.py): the JAX
# script's defaults, and the flagship size with the entry budget sized from the
# demand (--max-dup 0). The kernels every run of the DP step launches.
SCALING_SIZES = {"jax_defaults": (20_000, 128, 1 << 16), "flagship": (1_010_000, RES, 0)}
# The fields of a kernel's row that were measured on some inputs.
MEASURED = ("max_abs_err", "ms", "event_ms", "ms_parts", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
SCALING_PATH = ("expand_entries", "permute_entries", "composite_forward", "composite_backward",
                "segment_sum_rows")


def scaling_kernels_phase(dev):
    """Kernels A, B (C = 13), C, P and D against their plain versions, with
    times and bounds, on the inputs the scaling harness's DP step gives them
    at each size of SCALING_SIZES: `bench_scaling.build` for one rank, whose
    step renders and differentiates batch row 0 through
    `train_step.loss_and_grads`, recorded here by `step_inputs` on the same
    state, camera, target, masks and draws. In process, before any NCCL
    group. Returns ({kernel: {size: measured fields}}, record)."""
    rows, record = {}, {"phase": "scaling_kernels"}
    for size, (n_gauss, res, max_dup) in SCALING_SIZES.items():
        s = bench_scaling.build(1, n_gauss, res, max_dup, dev)
        b = s.batch
        x = step_inputs(s.state, b.camera(0), b.gt_image[0], b.sky_mask[0],
                        b.occluders_mask[0], b.uid[0], s.mlp, s.cfg, s.rcfg, s.bg, dev,
                        draws=s.draws[0])
        a_row, a_rec = hold_expansion(x["expand"], f"scaling harness step, {size}")
        if a_row["name"] != "expand_entries":
            raise AssertionError(f"scaling harness step, {size}: the binning walked row "
                                 "intervals, not rects")
        # The plain compositor takes 4-10 s a call at the flagship's ~32M entries.
        table, rec = hold_step_kernels(x, s.rcfg, dev, plain_iters=1)
        for row in [a_row] + table:
            rows.setdefault(row["name"], {})[size] = {k: row[k] for k in MEASURED if k in row}
        record[size] = {"scene_gaussians": n_gauss + bench_scaling.N_SKY,
                        "resolution": [res, res],
                        "max_dup": s.rcfg.max_dup, "expand": a_rec, **rec}
        del s, b, x, table
        torch.cuda.empty_cache()
    return rows, record


def scaling_phase():
    """The scaling harness in its own process (its ranks in theirs: no NCCL
    group of this process can hide kernels from a profiler there) at each
    size of SCALING_SIZES, NCCL ranks 1, 2, 4, ... up to the visible cards:
    every n with zero overflow, finite losses and launches of A, P, B, C and
    D (summed over its ranks). One card gives n = 1 alone: a per-card
    baseline of the DP step, not a scaling number."""
    cards = torch.cuda.device_count()
    want_n = [1 << i for i in range(cards.bit_length())]
    runs, launches = {}, collections.Counter()
    for name, (n_gauss, res, max_dup) in SCALING_SIZES.items():
        t0 = time.perf_counter()
        rc, log, err = run_module(SCRIPTS + "bench_scaling",
                                  ["--n-gauss", str(n_gauss), "--res", str(res), "--max-dup",
                                   str(max_dup), "--ranks", str(cards), "--backend", "nccl"])
        if rc != 0:
            raise AssertionError(f"bench_scaling {name}: exit {rc}:\n{(log + err)[-3000:]}")
        out = json.loads(log.strip().splitlines()[-1])
        entries = out["scaling"]
        if sorted(map(int, entries)) != want_n or "shared_card" in out:
            raise AssertionError(f"bench_scaling {name}: ran n = {sorted(entries)} on {cards} "
                                 f"card(s)")
        for n, e in entries.items():
            missing = [k for k in SCALING_PATH if e["launches"][k] < 1]
            if (e["overflow"] != 0 or not np.isfinite([e["loss"], e["last_loss"]]).all()
                    or not e["device_ms_per_step"] > 0
                    or missing or e["backend"] != "nccl" or e["ranks_per_card"] != 1):
                raise AssertionError(f"bench_scaling {name} n = {n}: {e} (no launch of "
                                     f"{missing})")
            launches.update(e["launches"])
        runs[name] = dict(out, process_wall_s=time.perf_counter() - t0,
                          log=[line for line in log.splitlines()[:-1]])
    record = {"phase": "scaling", "cards": cards, "runs": runs,
              "launches": {k: launches[k] for k in KERNELS}}
    if cards < 2:
        record["not_measured"] = (f"n >= 2: the machine has {cards} card; NCCL refuses two "
                                  "ranks on one card, so n = 1 is a per-card baseline of the "
                                  "DP step, not a scaling number")
    return dict(launches), record


# The measurement scripts (scripts/bench.py, stage_pie.py, parity.py,
# bench_train_step.py): each bench case's own knobs (the rest at the script's
# defaults: 1,000,000 Gaussians, 800x800, 10 timed calls) and the kernels it
# launches (every other kernel stays at 0).
BENCH_CASES = {"train": {}, "train_aniso8": {"BENCH_ANISO": "8"},
               "render": {"BENCH_MODE": "render"},
               "render_packed": {"BENCH_MODE": "render", "BENCH_PACKED": "1"},
               "render_lod": {"BENCH_MODE": "render", "BENCH_SKIP_ALPHA": "0.0625"}}
BENCH_TRAIN_KERNELS = ("permute_entries", "composite_forward", "composite_backward",
                       "segment_sum_rows")
# Every case launches kernel I in `bench.build`'s probe of the entry demand.
BENCH_LAUNCHES = {"train": ("row_intervals", "expand_entries") + BENCH_TRAIN_KERNELS,
                  "train_aniso8": ("row_intervals", "expand_entries_intervals")
                  + BENCH_TRAIN_KERNELS,
                  "render": ("row_intervals", "expand_entries", "permute_entries",
                             "composite_forward"),
                  "render_packed": ("row_intervals", "expand_entries", "permute_entries",
                                    "composite_forward_packed"),
                  "render_lod": ("row_intervals", "expand_entries", "permute_entries",
                                 "composite_forward")}
BENCH_PROBE = {"BENCH_N": "200000", "BENCH_MAX_DUP": "262144", "BENCH_ITERS": "3"}
SCRIPTS = "relightable3dgaussians_w_torch.scripts."


def bench_env(name):
    """The BENCH_* knobs of a case, at this script's scene size (the bench's
    defaults: N_GAUSS Gaussians at RES x RES)."""
    return {"BENCH_N": str(N_GAUSS), "BENCH_RES": str(RES), **BENCH_CASES[name]}


def bench_case(name, smi_line, dev):
    """One in-process run of `bench.run` with BENCH_CASES[name]: its record,
    wall seconds and launches, held to zero overflow, every pie stage > 0, the
    card line, row intervals on exactly in the anisotropic case, and
    BENCH_LAUNCHES[name]."""
    before = launch_counts()
    t0 = time.perf_counter()
    rec = bench.run(dev, bench_env(name))
    wall_s = time.perf_counter() - t0
    now = launch_counts()
    n = {k: now[k] - before[k] for k in now}
    x = rec["extra"]
    pie = x.get("stage_pie_ms", {})
    want = BENCH_LAUNCHES[name]
    bad = [what for what, failed in (
        ("overflow", x["overflow_entries"] != 0),
        ("stage pie", "stage_pie_error" in x or not pie or min(pie.values()) <= 0),
        ("card line", x["card"] != smi_line),
        ("row intervals", x["row_intervals"] != (name == "train_aniso8")),
        ("launches", any(n[k] < 1 for k in want) or any(n[k] for k in n if k not in want)))
        if failed]
    rec = dict(rec, wall_s=wall_s, launches=n)
    if bad:
        emit({"phase": "bench", "case": name, **rec})
        raise AssertionError(f"bench {name}: {', '.join(bad)} wrong")
    return rec


def bench_cli(script, env=None):
    """`python -m` one of the measurement scripts: (exit code, its standard
    output's lines, the end of its log)."""
    rc, out, err = run_module(SCRIPTS + script, [], env=env)
    return rc, out.splitlines(), (out + err)[-3000:]


def bench_phase(dev, smi_line):
    """The measurement scripts: BENCH_CASES in process through `bench.run`
    (the launch counts of the bench path); then, outside the count, kernels A,
    A-int, B (C = 3), C, P and D on the inputs the train case gives them
    (A-int: BENCH_ANISO=8) against their plain versions with times and bounds;
    then one subprocess of each CLI, each printing its one JSON line: the
    bench's overflow probe (BENCH_PROBE: overflow > 0, no crash), the parity
    probe at its defaults (ok) and the train-step bench at its defaults (zero
    overflow). Returns (launches, {kernel: row at the bench's shapes},
    record)."""
    reset_launches()
    cases = {name: bench_case(name, smi_line, dev) for name in BENCH_CASES}
    launches = launch_counts()

    n = N_GAUSS
    arrs, cam, cfg = bench.build(n, RES, RES, device=dev, env=bench_env("train"))
    leaves = [a.detach().requires_grad_(True) for a in arrs]
    bg = torch.zeros(3, device=dev)

    def forward():
        img, aux = rasterize.rasterize(*leaves, bg, cam, cfg, device=dev)
        return img.sum() + aux.alpha.sum(), aux.overflow

    x = graph_inputs(forward, leaves, n, "the bench's train call")
    rows, holds = hold_step_kernels(x, cfg, dev)
    a_row, holds["expand"] = hold_expansion(x["expand"], "bench train call")
    del x, leaves
    arrs8, cam8, cfg8 = bench.build(n, RES, RES, device=dev, env=bench_env("train_aniso8"))
    with torch.no_grad():
        _, calls, iv_calls = recorded_expansions(
            lambda: rasterize.rasterize(*arrs8, bg, cam8, cfg8, device=dev))
    ai_row, holds["expand_intervals"] = hold_expansion(calls[0], "bench train call, aniso 8")
    i_row, holds["row_intervals"] = hold_row_intervals(iv_calls[0], "bench train call, aniso 8")
    del arrs8, calls, iv_calls
    at_bench = dict(zip(("composite_forward", "composite_backward", "segment_sum_rows",
                         "permute_entries"), rows),
                    expand_entries=a_row, expand_entries_intervals=ai_row, row_intervals=i_row)
    # The aniso-8 case once more with the eager plain pass in kernel I's place,
    # the route before kernel I (outside the launch count).
    inner = row_intervals_kernel.row_intervals
    row_intervals_kernel.row_intervals = eager_row_intervals
    try:
        eager = bench.run(dev, bench_env("train_aniso8"))
    finally:
        row_intervals_kernel.row_intervals = inner
    eager_pass = {k: eager["extra"].get(k) for k in ("ms_per_iter", "device_ms_per_iter",
                                                     "overflow_entries", "stage_pie_ms")}

    cli = {}
    rc, lines, log = bench_cli("bench", BENCH_PROBE)
    probe = json.loads(lines[0]) if rc == 0 and len(lines) == 1 else None
    if probe is None or probe["extra"]["overflow_entries"] <= 0 \
            or probe["extra"]["card"] != smi_line:
        raise AssertionError(f"bench overflow probe: exit {rc}, lines {lines}:\n{log}")
    cli["bench_overflow_probe"] = dict(probe, env=BENCH_PROBE)
    rc, lines, log = bench_cli("parity")
    rep = json.loads(lines[0]) if len(lines) == 1 else None
    if rc != 0 or rep is None or not rep["ok"] or rep["backend"] != "cuda" \
            or rep["card"] != smi_line:
        raise AssertionError(f"parity: exit {rc}, lines {lines}:\n{log}")
    cli["parity"] = rep
    rc, lines, log = bench_cli("bench_train_step")
    step = json.loads(lines[-1]) if rc == 0 and lines else None
    if step is None or step["overflow"] != 0 or step["card"] != smi_line \
            or not np.isfinite(step["loss"]):
        raise AssertionError(f"bench_train_step: exit {rc}, lines {lines}:\n{log}")
    cli["bench_train_step"] = dict(step, lines=lines[:-1])
    record = {"phase": "bench", "cases": cases, "train_aniso8_eager_row_intervals": eager_pass,
              "kernels_at_bench_shapes": holds, "cli": cli}
    return launches, at_bench, record


PARALLEL_BANDS = (2, 5)                 # tile-parallel bands over grid_y = 50
PARALLEL_ITERS, PARALLEL_RESUME_ITERS = 24, 8
PARALLEL_SCHEDULE = ["optimizer.densify_from_iter=8", "optimizer.densification_interval=12",
                     "optimizer.opacity_reset_interval=20", "runtime.pool_headroom=2"]
PARALLEL_DIR = WORK_DIR / "parallel"
RANK_TIMEOUT_S = 600                    # a rank group's wait; every rank is killed after it
RANK_DEVICE = "cuda:0"                  # every rank of (c) and (d) shares the one card
GRAD_TOL = 5e-3



def grad_errs(got, want):
    return [rel_err(g, w) for g, w in zip(got, want)]


def render_grads(fn, leaves, weights):
    """Image, alpha, radii and the gradients of sum(image * w_img + alpha *
    w_alpha) with respect to `leaves` (means, colors, opacities, probe) from
    `fn(xyz, colors, op, probe) -> (image, aux)`."""
    args = [x.detach().clone().requires_grad_(True) for x in leaves]
    img, aux = fn(*args)
    loss = (img * weights[0]).sum() + (aux.alpha * weights[1]).sum()
    grads = torch.autograd.grad(loss, args)
    return img.detach(), aux.alpha.detach(), aux.radii, [g.detach() for g in grads], aux


def band_rcfg(host, cam, k):
    """host.rcfg with an entry budget whose k-th part holds the densest of k
    bands of tile rows (a band gets max_dup / k, `tile_parallel.band_config`)."""
    p, s = host.state.gaussians, host.state.gauss_state
    rcfg = host.rcfg
    with torch.no_grad():
        pre = preprocess.preprocess(G.get_xyz(p, s), G.get_scaling(p), G.get_rotation(p),
                                    cam.viewmat, cam.projmat, cam.tan_fovx, cam.tan_fovy, RES,
                                    RES, 16, active=s.alive, opacities=G.get_opacity(p, s)[:, 0],
                                    skip_alpha=rcfg.skip_alpha)
        gy = rcfg.grid_y // k
        need = max(int(TP._band_pre(pre, b * gy, gy, 16).tiles_touched.sum()) for b in range(k))
    return rcfg._replace(max_dup=max(rcfg.max_dup, ((int(need * k * 1.05) + 4095) // 4096) * 4096))


def tile_parallel_check(host, ts, dev):
    """(a) Tile-parallel bands on cuda:0 in this process: the image, alpha and
    radii bitwise equal to the single-device `rasterize` at C = 3 (the served
    frame) and C = 13 (the training step's leaf inputs), and the gradients of
    means, colors, opacities and the mean2d probe within GRAD_TOL."""
    rcfg, alive = host.rcfg, host.state.gauss_state.alive
    out = {}
    with torch.no_grad():
        cam, xyz, scl, quat, op, rgb = frame_inputs(host, 0.0, dev)
        draws = TS.make_draws(torch.Generator(device=dev).manual_seed(0), ts.mlp, ts.cfg)
        inp, _ = TS.make_leaf_inputs(ts.state.params, ts.state.gauss_state, ts.mlp, ts.cam, 0,
                                     draws, ts.cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    for C, colors, camera, opac in ((3, rgb, cam, op), (13, inp.colors, ts.cam, inp.opacity[:, 0])):
        bg = torch.rand(C, generator=gen, device=dev)
        weights = (torch.randn((RES, RES, C), generator=gen, device=dev),
                   torch.randn((RES, RES), generator=gen, device=dev))
        probe = torch.zeros((xyz.shape[0], 2), device=dev)

        def single(x, c, o, pr):
            return rasterize.rasterize(x, scl, quat, o, c, bg, camera, rcfg, active=alive,
                                       device=dev, mean2d_probe=pr)

        ref = render_grads(single, (xyz, colors, opac, probe), weights)
        if int(ref[4].overflow) != 0:
            raise AssertionError(f"parallel (a): single-device overflow at C = {C}")
        ms_single = median_ms(lambda: single(xyz, colors, opac, None), 5)
        for k in PARALLEL_BANDS:
            fn, kcfg = TP.make_tile_parallel_raster_fn([dev] * k), band_rcfg(host, camera, k)

            def banded(x, c, o, pr, fn=fn, kcfg=kcfg):
                return fn(x, scl, quat, o, c, bg, camera, kcfg, mean2d_probe=pr, active=alive)

            got = render_grads(banded, (xyz, colors, opac, probe), weights)
            for name, a, b in (("image", got[0], ref[0]), ("alpha", got[1], ref[1]),
                               ("radii", got[2], ref[2])):
                if not torch.equal(a, b):
                    raise AssertionError(f"parallel (a): {k} bands, C = {C}: {name} differs")
            errs = grad_errs(got[3], ref[3])
            if not max(errs) < GRAD_TOL:
                raise AssertionError(f"parallel (a): {k} bands, C = {C}: gradient errors {errs}")
            out[f"c{C}_bands{k}"] = {
                "image_alpha_radii": "bitwise equal", "overflow": int(got[4].overflow),
                "max_dup": kcfg.max_dup, "band_max_dup": TP.band_config(kcfg, k).max_dup,
                "grad_rel_err": dict(zip(("means", "colors", "opacities", "probe"), errs)),
                "forward_ms": median_ms(lambda: banded(xyz, colors, opac, None), 5),
                "single_forward_ms": ms_single}
    return out


def nccl_one_rank_check(host, ts, dev):
    """(b) NCCL at one rank in this process (tcp://127.0.0.1): the gauss-sharded
    render with D = 1 bitwise equal to `rasterize`, and the DP step on a 1 x 1
    mesh against `train_step` on the same inputs; the group is destroyed after."""
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        alive_check = torch.ones(1, device=dev)
        dist.all_reduce(alive_check)
        dist.barrier()
        with torch.no_grad():
            cam, xyz, scl, quat, op, rgb = frame_inputs(host, 0.0, dev)
            ref, ref_aux = rasterize.rasterize(xyz, scl, quat, op, rgb, host.bg_color, cam,
                                               host.rcfg, active=host.state.gauss_state.alive,
                                               device=dev)
            img, aux = GS.rasterize_gauss_sharded(xyz, scl, quat, op, rgb, host.bg_color, cam,
                                                  host.rcfg, dist.group.WORLD,
                                                  active=host.state.gauss_state.alive)
        if not (torch.equal(img, ref) and torch.equal(aux.alpha, ref_aux.alpha)
                and int(aux.overflow) == 0):
            raise AssertionError("parallel (b): the D = 1 gauss-sharded render differs")

        mesh = make_mesh(1, 1, dev)
        draws = TS.make_draws(torch.Generator(device=dev).manual_seed(0), ts.mlp, ts.cfg)
        c = ts.cam
        batch = DP.CameraBatch(c.viewmat[None], c.projmat[None], c.campos[None],
                               c.tan_fovx[None], c.tan_fovy[None], ts.gt[None], ts.ones[None],
                               ts.ones[None], torch.zeros(1, dtype=torch.int64, device=dev))
        new_dp, m = DP.make_dp_train_step(ts.mlp, ts.cfg, ts.rcfg, mesh)(ts.state, batch, [draws],
                                                                         ts.bg)
        new_ts, aux = TS.train_step(ts.state, *ts.args(draws), device=dev)
        loss_err = abs(float(m.loss) - float(aux.loss)) / abs(float(aux.loss))
        errs = {name: rel_err(a, b) for name, a, b in zip(
            [f"leaf_{i}" for i in range(len(TS.tree_leaves(new_ts.params)))],
            TS.tree_leaves(new_dp.params), TS.tree_leaves(new_ts.params))}
        worst = max(errs.values())
        if not (loss_err < 1e-5 and worst < GRAD_TOL and int(new_dp.step) == int(new_ts.step)):
            raise AssertionError(f"parallel (b): DP step vs train_step: loss {loss_err}, "
                                 f"params {worst}")
        return {"backend": dist.get_backend(), "ranks": 1,
                "gauss_sharded_d1": "bitwise equal to rasterize",
                "dp_step_1x1": {"loss_rel_err": loss_err, "param_max_rel_err": worst,
                                "bitwise_params": all(torch.equal(a, b) for a, b in zip(
                                    TS.tree_leaves(new_dp.params),
                                    TS.tree_leaves(new_ts.params)))}}
    finally:
        dist.destroy_process_group()


def run_rank_group(mode, world, extra, label):
    """`world` processes of this script in rank mode `mode`, each writing its
    JSON record under PARALLEL_DIR; all killed when one fails or the wait runs
    out. Returns the records in rank order."""
    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    port = free_port()
    outs = [PARALLEL_DIR / f"{mode}_rank{r}.json" for r in range(world)]
    for o in outs:
        o.unlink(missing_ok=True)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank", mode,
                               str(r), str(world), str(port), str(outs[r]), *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"parallel {label}: rank {r} exited {p.returncode}:\n"
                                 f"{log[-3000:]}")
    return [json.loads(o.read_text()) for o in outs]


def rank_gauss2(rank, world, port, dev):
    """(c) One of 2 gloo ranks sharing cuda:0: the full-width gauss-sharded
    render (D = 2) against the single-device render, then the data = 2 DP
    step's per-image losses against the single-device forward losses."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    with torch.no_grad():
        host, cam0, _ = build_host(dev)
    alive = host.state.gauss_state.alive
    rec = {}
    with torch.no_grad():
        cam, xyz, scl, quat, op, rgb = frame_inputs(host, 0.0, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    weights = (torch.randn((RES, RES, 3), generator=gen, device=dev),
               torch.randn((RES, RES), generator=gen, device=dev))
    probe = torch.zeros((xyz.shape[0], 2), device=dev)

    def single(x, c, o, pr):
        return rasterize.rasterize(x, scl, quat, o, c, host.bg_color, cam, host.rcfg,
                                   active=alive, device=dev, mean2d_probe=pr)

    ref = render_grads(single, (xyz, rgb, op, probe), weights)
    n = xyz.shape[0] // world
    sl = slice(rank * n, (rank + 1) * n)
    loc = [x[sl] for x in (xyz, scl, quat, op, rgb, probe)]
    kcfg = band_rcfg(host, cam, world)

    def sharded(x, c, o, pr):
        return GS.rasterize_gauss_sharded(x, loc[1], loc[2], o, c, host.bg_color, cam, kcfg,
                                          dist.group.WORLD, mean2d_probe=pr, active=alive[sl])

    # Every rank's loss reads the full image: its weights are divided by D (the
    # ranks' losses sum to the single-device loss; exact for D = 2).
    reset_launches()
    got = render_grads(sharded, (loc[0], loc[4], loc[3], loc[5]), [w / world for w in weights])
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            and torch.equal(got[2], ref[2]) and int(got[4].overflow) == 0):
        raise AssertionError("parallel (c): the D = 2 gauss-sharded render differs")
    errs = grad_errs(got[3], [g[sl] for g in ref[3]])
    if not max(errs) < GRAD_TOL:
        raise AssertionError(f"parallel (c): gauss-sharded gradient errors {errs}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        GS.rasterize_gauss_sharded(loc[0], loc[1], loc[2], loc[3], loc[4], host.bg_color, cam,
                                   kcfg, dist.group.WORLD, active=alive[sl])
    torch.cuda.synchronize()
    rec["gauss_sharded"] = {"image_alpha_radii": "bitwise equal", "overflow": 0,
                            "max_dup": kcfg.max_dup,
                            "grad_rel_err": dict(zip(("means", "colors", "opacities", "probe"),
                                                     errs)),
                            "forward_ms": (time.perf_counter() - t0) * 1e3}

    # The data = 2 step on two views (yaw -5 and +5, each the port's render
    # under embedding 1): each rank's first-step loss against the single-device
    # forward loss of its image with the same draws.
    ts = TrainSetup(host, cam0, dev)
    cams = [synthetic.camera(RES, RES, viewmat=yaw(deg), device=dev) for deg in (-5.0, 5.0)]
    m = ts.cfg.model
    with torch.no_grad():
        envl, sky = host.mlp(host.state.embeddings[1][None])
        gts = [render(host.state.gaussians, host.state.gauss_state, envl[0], sky, c, ts.rcfg,
                      ts.bg, ts.ones, m.envlight_sh_degree, m.sky_sh_degree, m.specular,
                      m.fix_sky, debug=False, device=dev).render.contiguous() for c in cams]
    batch = DP.CameraBatch(*[torch.stack([getattr(c, f) for c in cams]) for f in
                             ("viewmat", "projmat", "campos", "tan_fovx", "tan_fovy")],
                           gt_image=torch.stack(gts), sky_mask=torch.stack([ts.ones] * 2),
                           occluders_mask=torch.stack([ts.ones] * 2),
                           uid=torch.tensor([0, 1], device=dev))
    draws_gen = torch.Generator(device=dev).manual_seed(0)
    draws = [TS.make_draws(draws_gen, ts.mlp, ts.cfg) for _ in range(2)]
    mesh = make_mesh(2, 1, dev)
    loss, aux, _, _ = DP.make_per_image_grads(ts.mlp, ts.cfg, ts.rcfg, mesh)(
        ts.state, batch, draws[rank], ts.bg)
    with torch.no_grad():
        want, _ = TS.forward_loss(ts.state.params, ts.state.gauss_state, None, ts.mlp,
                                  cams[rank], gts[rank], ts.ones, ts.ones, rank, draws[rank],
                                  ts.state.step, ts.cfg, ts.rcfg, ts.bg, device=dev)
    loss_err = abs(float(loss) - float(want)) / abs(float(want))
    if not loss_err < 1e-5:
        raise AssertionError(f"parallel (c): rank {rank} per-image loss {float(loss)} against "
                             f"the single-device {float(want)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, metrics = DP.make_dp_train_step(ts.mlp, ts.cfg, ts.rcfg, mesh)(ts.state, batch, draws,
                                                                        ts.bg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    if not (np.isfinite(float(metrics.loss)) and int(metrics.overflow) == 0
            and int(new.step) == int(ts.state.step) + 2 and params_finite(new)):
        raise AssertionError(f"parallel (c): the data = 2 step: {metrics}")
    rec["dp_data2"] = {"per_image_loss": float(loss), "single_device_loss": float(want),
                       "loss_rel_err": loss_err, "step_ms": step_ms,
                       "mean_loss": float(metrics.loss)}
    dist.destroy_process_group()
    return rec


def rank_cli(rank, world, port, dev):
    """(d) One of 4 gloo ranks sharing cuda:0 through `cli.train.main`: data 2 x
    gauss 2 on the trainer phase's dataset, PARALLEL_ITERS iterations with a
    save, then a resume of PARALLEL_RESUME_ITERS from the checkpoint. Times
    every DP step (host clock after a device sync) and keeps its overflow."""
    from relightable3dgaussians_w_torch.trainer import Relightable3DGWTrainer as Trainer

    out = PARALLEL_DIR / "out"
    argv = [f"dataset.source_path={SCENE_DIR}", f"dataset.model_path={out}", *PARALLEL_SCHEDULE,
            "runtime.max_dup=0", "runtime.data_parallel=2", "runtime.gauss_shards=2",
            f"runtime.coordinator_address=127.0.0.1:{port}", f"runtime.num_processes={world}",
            f"runtime.process_id={rank}", "--dist-backend=gloo", f"--device={dev.type}"]
    inner, steps, coll_ms = Trainer._dp_train_step, [], [0.0]
    gather, all_to_all = C._gather, C._all_to_all

    def timed_collective(fn):
        """The all-gathers and all-to-alls (host-staged over gloo) with a
        device sync on each side, their ms summed into coll_ms."""
        def run(x, group):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, group)
            torch.cuda.synchronize()
            coll_ms[0] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    def timed(self, views):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), coll_ms[0]
        state, metrics = inner(self, views)
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t0) * 1e3, int(metrics.overflow),
                      float(metrics.loss), coll_ms[0] - c0))
        return state, metrics

    Trainer._dp_train_step = timed
    C._gather, C._all_to_all = timed_collective(gather), timed_collective(all_to_all)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        tr = cli_train.main(argv + [f"optimizer.iterations={PARALLEL_ITERS}"])
        train_s = time.perf_counter() - t0
        n_train = len(steps)
        tr = cli_train.main(argv + [f"optimizer.iterations={PARALLEL_RESUME_ITERS}",
                                    f"model.load_iteration={PARALLEL_ITERS}"])
    finally:
        Trainer._dp_train_step = inner
        C._gather, C._all_to_all = gather, all_to_all
    return {"rank": rank, "collective_ms": [s[3] for s in steps], "device": str(tr.device), "is_main": tr.is_main,
            "mesh_cell": [tr.mesh.d, tr.mesh.g], "launches": launch_counts(),
            "peak_memory_mb": torch.cuda.max_memory_allocated(dev) / 2**20,
            "step_ms": [s[0] for s in steps], "overflow": [s[1] for s in steps],
            "losses": [s[2] for s in steps], "train_steps": n_train,
            "train_call_s": train_s, "total_s": time.perf_counter() - t0,
            "final_step": int(tr.state.step), "final_max_dup": tr.rcfg.max_dup,
            "host_staged": sorted(C.HOST_STAGED)}


def rank_main(argv) -> int:
    """`chip_smoke.py --rank <mode> <rank> <world> <port> <out.json>`: one rank
    of a parallel-phase group on cuda:0."""
    mode, rank, world, port, out = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    dev = torch.device(RANK_DEVICE)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rec = {"gauss2": rank_gauss2, "cli": rank_cli}[mode](rank, world, port, dev)
    if mode == "gauss2":
        rec["launches"] = launch_counts()
    Path(out).write_text(json.dumps(rec))
    return 0


def parallel_phase_ranks(dev):
    """(c) and (d): the rank groups, after the parent's device memory is freed.
    Returns (the (d) ranks' summed launches, record)."""
    t0 = time.perf_counter()
    g2 = run_rank_group("gauss2", 2, [], "(c)")
    g2_s = time.perf_counter() - t0
    shutil.rmtree(PARALLEL_DIR / "out", ignore_errors=True)
    t0 = time.perf_counter()
    ranks = run_rank_group("cli", 4, [], "(d)")
    cli_s = time.perf_counter() - t0

    out = PARALLEL_DIR / "out"
    recs = [json.loads(line) for line in open(out / "train_log.jsonl")]
    events = [r for r in recs if "event" in r]
    evals = [r for r in recs if "train_psnr" in r]
    resumed = [r["step"] for r in events if r["event"] == "resume"]
    if resumed != [PARALLEL_ITERS]:
        raise AssertionError(f"parallel (d): resumed at {resumed}")
    if not evals or not all(np.isfinite(r["train_psnr"]) for r in evals):
        raise AssertionError(f"parallel (d): evaluation {evals}")
    for rel in (f"point_cloud/iteration_{PARALLEL_ITERS}/point_cloud.ply",
                f"full_state/iteration_{PARALLEL_ITERS}/state.npz",
                f"point_cloud/iteration_{PARALLEL_RESUME_ITERS}/point_cloud.ply"):
        if not (out / rel).exists():
            raise AssertionError(f"parallel (d): {rel} missing")
    if [r["is_main"] for r in ranks] != [True, False, False, False]:
        raise AssertionError("parallel (d): rank 0 is not the only writer")
    for r in ranks:
        over = r["overflow"]
        # Every overflow is healed at once: no two overflowing steps in a row,
        # and the last step of each leg exact.
        if (over[r["train_steps"] - 1] or over[-1]
                or any(a and b for a, b in zip(over, over[1:]))):
            raise AssertionError(f"parallel (d): rank {r['rank']} overflow {over}")
        if not np.isfinite(r["losses"]).all():
            raise AssertionError(f"parallel (d): rank {r['rank']} losses {r['losses']}")
        if r["final_step"] != PARALLEL_ITERS + PARALLEL_RESUME_ITERS:
            raise AssertionError(f"parallel (d): rank {r['rank']} ended at {r['final_step']}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}
    missing = [k for k in TRAIN_PATH[1:] if launches[k] < 1]
    if missing or launches["expand_entries"] + launches["expand_entries_intervals"] < 1:
        raise AssertionError(f"parallel (d): no launch of {missing or 'A / A-int'}")
    label = "4 ranks sharing one card over gloo"
    record = {
        "gauss_sharded_2_ranks": {"backend": "gloo", "ranks": 2, "cards": 1, "wall_s": g2_s,
                                  "label": "2 ranks sharing one card over gloo",
                                  "per_rank": g2},
        "cli_4_ranks": {
            "backend": "gloo", "ranks": 4, "cards": 1, "mesh": "data 2 x gauss 2",
            "label": label, "wall_s": cli_s,
            "argv_extra": PARALLEL_SCHEDULE + [f"optimizer.iterations={PARALLEL_ITERS}",
                                               f"then {PARALLEL_RESUME_ITERS} from the "
                                               "checkpoint"],
            "resumed_step": resumed[0], "train_psnr": [r["train_psnr"] for r in evals],
            "events": [{k: r[k] for k in ("iter", "event", "ms") if k in r} for r in events],
            "per_rank": [{k: r[k] for k in ("rank", "device", "mesh_cell", "launches",
                                            "peak_memory_mb", "train_call_s", "total_s",
                                            "final_max_dup", "overflow", "host_staged")}
                         | {"ms_per_dp_step_median": float(np.median(r["step_ms"][1:])),
                            "collective_ms_per_step_median":
                                float(np.median(r["collective_ms"][1:])),
                            "step_ms": r["step_ms"], "collective_ms": r["collective_ms"]}
                         for r in ranks]},
        "host_staged_gloo_ops": sorted({op for r in ranks for op in r["host_staged"]}),
    }
    return launches, record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi_line = card_line(dev)
    report = lambda rec: emit({**rec, "card": smi_line})  # every number with its card
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    report({"phase": "device", "kind": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda, "kernel_build_s": build_s})

    t0 = time.perf_counter()
    with torch.no_grad():   # plain tensors: the training phase differentiates them
        host, cam0, demand = build_host(dev)
    torch.cuda.synchronize()
    report({"phase": "scene", "gaussians": N_GAUSS + N_SKY, "resolution": [RES, RES],
            "entry_demand": demand, "max_dup": host.rcfg.max_dup,
            "build_s": time.perf_counter() - t0})
    with torch.inference_mode():
        table, ref_img, record = kernels_phase(host, dev)
        report(record)
        report(stages_phase(host, dev))
        serve_launches, exact_frames, serve_record = serve_phase(host, cam0, ref_img, dev)
        report(serve_record)
        packed_launches, packed_row, record = serve_packed_phase(host, cam0, exact_frames,
                                                                 serve_record, dev)
        report(record)
        report(reference_phase(dev))
    # Before any NCCL group of this process: torch.profiler (the bench's
    # device_ms_per_iter) missed kernels late in the process, after them.
    t0 = time.perf_counter()
    bench_launches, bench_rows, record = bench_phase(dev, smi_line)
    report({**record, "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scaling_rows, record = scaling_kernels_phase(dev)
    report({**record, "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shade_table, record = shading_phase(dev)
    report({**record, "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    view_table, record = view_unpack_phase(dev)
    report(record)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pre_table, record = preprocess_phase(dev)
    report({**record, "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    ts = TrainSetup(host, cam0, dev)
    a_step_row, train_table, record = train_kernels_phase(ts, dev)
    report(record)
    train_launches, record = train_phase(ts, dev)
    report(record)
    t0 = time.perf_counter()
    par_a = tile_parallel_check(host, ts, dev)
    a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    par_b = nccl_one_rank_check(host, ts, dev)
    b_s = time.perf_counter() - t0
    del ts

    report(intervals_phase(host, dev))
    trainer_launches, iv_entry, i_entry, trainer_table, record = trainer_phase(host, dev)
    report(record)
    pretrain_data_s = write_pretrain_dataset(host, dev)
    fg_points = host.state.gaussians.xyz[:N_GAUSS].detach().clone()
    del host
    eval_launches, by_c, eval_rows, record = eval_phase(dev)
    report(record)
    pretrain_launches, record = pretrain_phase(dev)
    report({**record, "dataset_write_s": pretrain_data_s})
    report(library_phase(fg_points, dev))
    del fg_points
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    selfcheck_launches, record = selfcheck_phase(dev)
    report({**record, "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    demo_launches, record = serve_demo_phase()
    report(record)
    t0 = time.perf_counter()
    scaling_launches, record = scaling_phase()
    report({**record, "wall_s": time.perf_counter() - t0})

    # The parallel phase's rank groups, with this process's device memory freed.
    parallel_launches, record = parallel_phase_ranks(dev)
    report({"phase": "parallel", "cards": 1,
            "tile_parallel": {"backend": "none (one process)", "bands": list(PARALLEL_BANDS),
                              "device": str(dev), "wall_s": a_s, **par_a},
            "nccl_one_rank": {**par_b, "wall_s": b_s}, **record,
            "not_measured": "multi-rank NCCL and scaling: the machine has one card, and NCCL "
                            "refuses two ranks on one card; no number here is a scaling number",
            "depth_cuts": [f"{PARALLEL_ITERS} + {PARALLEL_RESUME_ITERS} trainer iterations "
                           "(of the default 40,000)", "runtime.pool_headroom=2 (of 8)"]})

    # Launches on each main path: serving (A, P, B at C = 3), packed serving
    # (A, P, B'), the training step (A, P, B at C = 13, C, D), the trainer with
    # row intervals (A-int, P, B at C = 13, C, D), the evaluation chain (A or
    # A-int, P, B at C = 13, 21 and 51, C, D) and the trainer after
    # pretraining (A or A-int, P, B at C = 13, C, D) and the 4 ranks of the
    # parallel phase's train CLI, summed (A or A-int, P, B at C = 13, C, D), the
    # self-check's two legs (A, P, B at C = 13, C, D), the serving demo's
    # frames, exact and packed (A, P, B at C = 3, B'), the bench's cases in
    # process (A, A-int, P, B at C = 3, B', C, D) and the scaling harness's
    # ranks at both sizes, summed (A, P, B at C = 13, C, D).
    paths = ("serve", "serve_packed", "train", "trainer", "eval", "pretrain", "parallel",
             "selfcheck", "serve_demo", "bench", "scaling")
    v, q, t, r, e, w, p, s, d, b, c = (serve_launches, packed_launches, train_launches,
                                       trainer_launches, eval_launches, pretrain_launches,
                                       parallel_launches, selfcheck_launches, demo_launches,
                                       bench_launches, scaling_launches)
    by_path = {k: (v[k], q[k], t[k], r[k], e[k], w[k], p[k], s[k], d[k], b[k], c[k])
               for k in KERNELS}
    by_path["composite_forward"] = (v["composite_forward"], q["composite_forward"], 0, 0, 0, 0,
                                    0, 0, d["composite_forward"], b["composite_forward"], 0)
    by_path["composite_forward_c13"] = (0, 0, t["composite_forward"], r["composite_forward"],
                                        by_c.get(13, 0), w["composite_forward"],
                                        p["composite_forward"], s["composite_forward"], 0, 0,
                                        c["composite_forward"])
    by_path["composite_forward_c21"] = (0, 0, 0, 0, by_c.get(21, 0), 0, 0, 0, 0, 0, 0)
    by_path["composite_forward_c51"] = (0, 0, 0, 0, by_c.get(51, 0), 0, 0, 0, 0, 0, 0)
    if (set(by_c) - {13, 21, 51} or q["composite_forward"] or t["composite_forward_packed"]
            or w["composite_forward_packed"] or p["composite_forward_packed"]
            or s["composite_forward_packed"] or c["composite_forward_packed"]):
        raise AssertionError(f"unexpected compositor launches: eval {by_c}, packed serving "
                             f"{q['composite_forward']}, train {t['composite_forward_packed']}, "
                             f"pretrain {w['composite_forward_packed']}")
    # B (C = 13), C and D: the numbers at the training step's shapes, and under
    # "at_trainer_shapes" those at the trainer's (A-int's row is the trainer's).
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "launches_by_path")
    measured = MEASURED
    for row, trow in zip(train_table, trainer_table):
        row["at_trainer_shapes"] = {k: trow[k] for k in measured if k in trow}
    table[0]["at_train_step"] = {k: a_step_row[k] for k in measured if k in a_step_row}
    b_rows = {C: dict(train_table[0], name=f"composite_forward_c{C}", **eval_rows[C])
              for C in (21, 51)}
    for row in b_rows.values():
        row.pop("at_trainer_shapes")
    table = (table[:1] + [iv_entry, i_entry] + table[1:] + [packed_row, train_table[0], b_rows[21],
                                                    b_rows[51]] + train_table[1:] + shade_table
             + view_table + pre_table)
    for entry in table:
        if entry["name"] in bench_rows:
            row = bench_rows[entry["name"]]
            entry["at_bench_shapes"] = {k: row[k] for k in measured if k in row}
        if entry["name"] in scaling_rows:
            entry["at_scaling_shapes"] = scaling_rows[entry["name"]]
        counts = by_path[entry["name"]]
        entry["launches"] = sum(counts)
        entry["launches_by_path"] = dict(zip(paths, counts))
    extra = ("event_ms", "ms_parts", "at_train_step", "at_trainer_shapes", "at_bench_shapes",
             "at_scaling_shapes", "at_serve_shapes", "ms_live_1010000", "at_collection_shapes")
    emit({"kernels": [{k: e[k] for k in keys + extra if k in e} for e in table]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--rank"]
             else shading_main() if sys.argv[1:2] == ["--shading"]
             else preprocess_main() if sys.argv[1:2] == ["--preprocess"]
             else view_unpack_main() if sys.argv[1:2] == ["--view-unpack"] else main())
