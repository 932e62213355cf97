"""Host-side orchestrator: scene setup, training loop, checkpoints.

Port of the JAX package's `trainer.py` (the reference's `Relightable3DGW` +
`Scene` + `train.py` driver). Device work is `train_step.train_step` and the
density-control steps; this module owns the schedule: the seeded view
sampling, one-step-delayed binning-overflow healing, the densify /
opacity-reset cadence with the annealed gradient threshold, pool growth, the
entry-budget probe, logging and the checkpoint layout.

Checkpoints use the reference's layout, and the JAX trainer's, so either
trainer loads what the other wrote:
    point_cloud/iteration_N/point_cloud.ply       (reference attributes)
    checkpoint_embeddings/iteration_N/embeddings_weights.npz
    checkpoint_MLP/iteration_N/MLP_weights.npz    (flax msgpack bytes)
    envlights_sh/iteration_N/envlight_sh_<image>.npy
    full_state/iteration_N/state.npz              (JAX leaf order, checkpoint.py)

The JAX trainer re-jits its step functions when the entry budget or the pool
grows; here a new `RasterizerConfig` (or a bigger pool) is all it takes.

With runtime.data_parallel x runtime.gauss_shards > 1 the trainer is one rank
of a mesh of processes (`parallel/`, one process per device): every rank runs
this same schedule with the same seed, takes B = data_parallel cameras a step
(`parallel/data_parallel.make_dp_train_step`, the schedule's iteration counter
advancing by B), keeps its gauss shard of the pool, reads the binning overflow
after a max over all ranks (so every rank heals the budget alike), densifies
on the pool gathered over its gauss group (the single-device densify, with the
same generator on every rank, then its own slice again), and leaves file and
log IO to rank 0: evaluation and checkpoints gather the full state on every
rank, rank 0 writes, then a barrier.

Random draws come from `torch.Generator`s seeded with `runtime.seed` (one on
the host for the sky seeding and the initial MLP and embeddings, one on the
device for the step draws and the split noise); the view order is the JAX
trainer's `np.random.RandomState(seed)` sequence.

The training photos live on the device in a view store
(`data/view_store.py`), each once at its own size in 8 bits; each step's
padded float32 view is built from it (`ViewStore.fetch`). `train_views` is
that store: `train_views[i]` gives a padded view dict, as `pad_cameras` makes.

Each iteration of the loop runs inside the `torch.profiler` range
"trainer.iteration", and its read of the previous step's overflow count (which
waits for that step on the device) and any healing inside
"trainer.overflow_read"; the view's build inside "trainer.view_fetch".
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image
from torch.func import functional_call

from . import checkpoint as CK
from . import train_step as TS
from .config import Config, config_to_dict
from .data.cameras import Camera, camera_to_json, scene_center
from .data.ply import read_ply, write_ply
from .data.readers import load_scene_info
from .data.view_store import ViewStore
from .device import resolve_device
from .models import gaussians as G
from .models.nets import MLPNet
from .ops.knn import knn_dist2
from .ops.preprocess import preprocess, row_intervals
from .ops.rasterize import RasterizerConfig
from .parallel import collectives as PC
from .parallel import data_parallel as DP
from .parallel import multihost
from .parallel.mesh import make_mesh
from .renderer import render
from .utils import losses as LO
from .utils.general import grad_thr_exp_scheduling, sample_points_on_unit_hemisphere
from .utils.logging import ProfilerWindow, TrainLogger
from .viewer import ServeState, ViewerServer, handle_viewer_request

ROW_INTERVALS_MIN_CUT = 0.15   # auto-enable row intervals at this entry cut


def pad_cameras(cams: list[Camera]):
    """Pad images/masks to the largest (H, W); padded pixels get
    occluders_mask = 0, which drops them from every masked loss."""
    H = max(c.height for c in cams)
    W = max(c.width for c in cams)
    out = []
    for c in cams:
        h, w = c.height, c.width
        img = np.zeros((H, W, 3), np.float32)
        img[:h, :w] = c.image
        sky, occ = np.zeros((H, W), np.float32), np.zeros((H, W), np.float32)
        for canvas, mask in ((sky, c.sky_mask), (occ, c.occluders_mask)):   # each read once
            canvas[:h, :w] = mask if mask is not None else 1.0
        out.append(dict(cam=c, image=img, sky_mask=sky, occluders_mask=occ))
    return out, H, W


def seed_sky_points(xyz: np.ndarray, cameras: list[Camera],
                    generator: torch.Generator | None = None, draws=None):
    """Sky Gaussian seeding: hemisphere points at the 0.99-quantile scene
    distance around the mean camera centre, kept where they land in the top 2/3
    of at least one camera. The hemisphere's uniform draws come from
    `generator` or are given as `draws` (u_y, u_phi)."""
    mean = xyz.mean(axis=0, keepdims=True)
    sky_distance = float(np.quantile(np.linalg.norm(xyz - mean, axis=-1), 0.99))
    center = scene_center(cameras)
    num = int(5000 * sky_distance)
    pts = sample_points_on_unit_hemisphere(num, generator, draws).cpu().numpy()
    pts = pts * sky_distance + center[None, :]
    keep = np.zeros(num, dtype=bool)
    for cam in cameras:
        uv = cam.project(pts[~keep])
        ok = ~np.isnan(uv).any(-1)
        ok &= uv[:, 1] < (2.0 / 3.0) * cam.height
        keep[~keep] |= ok
    return pts[keep], sky_distance, center


def size_entry_budget(max_dup: int, row_iv: bool, auto: bool, rect_demand, iv_demand):
    """(row_intervals, max_dup) from the probe's demands: intervals switch on
    when asked for, or (auto) when they cut the demand by >= 15%; max_dup = 0
    sizes the budget at 1.3x the demand, in multiples of 4096 within
    [2^15, 2^23]."""
    if not row_iv and auto and rect_demand:
        row_iv = 1.0 - iv_demand / max(rect_demand, 1) >= ROW_INTERVALS_MIN_CUT
    if max_dup == 0:
        demand = iv_demand if row_iv else rect_demand
        max_dup = min(max(((int(demand * 1.3) + 4095) // 4096) * 4096, 1 << 15), 1 << 23)
    return row_iv, max_dup


class _ViewerHost:
    """What the port's viewer reads from its host, for the training state."""

    def __init__(self, trainer: "Relightable3DGWTrainer"):
        p = trainer.state.params
        self.W, self.H, self.rcfg, self.cfg = trainer.W, trainer.H, trainer.rcfg, trainer.cfg
        self.bg_color = trainer.bg_color
        trainer.mlp.load_state_dict(p["mlp"])   # training reads p["mlp"] functionally
        self.mlp = trainer.mlp
        self.state = ServeState(p["gaussians"], trainer.state.gauss_state, p["embeddings"])


class Relightable3DGWTrainer:
    def __init__(self, cfg: Config, device: str | torch.device = "cuda",
                 dist_backend: str | None = None):
        """Load the scene and build the pool, the nets and the optimizer state
        on `device` ("cuda" by default; raises when CUDA is absent). With a
        mesh (runtime.data_parallel x runtime.gauss_shards > 1) this process is
        one rank of it: the process group comes from the config or the
        launcher's environment (`parallel/multihost.maybe_initialize`, NCCL for
        CUDA and gloo for the CPU unless `dist_backend` names one) and the rank
        runs on cuda:(local rank % visible cards)."""
        self.cfg = cfg
        rt = cfg.runtime
        self.data_ax, self.gauss_ax = max(rt.data_parallel, 1), max(rt.gauss_shards, 1)
        n_mesh = self.data_ax * self.gauss_ax
        dev = resolve_device(device)
        multihost.maybe_initialize(rt, dev, dist_backend)
        self.is_main = multihost.is_main()
        self.multiprocess = multihost.is_multiprocess()
        if self.multiprocess and n_mesh == 1:
            raise RuntimeError("multi-process training needs a mesh: set runtime.data_parallel "
                               "(and optionally runtime.gauss_shards) to span all ranks")
        self.mesh = None
        if n_mesh > 1:
            if not self.multiprocess:
                raise RuntimeError(
                    f"mesh data={self.data_ax} x gauss={self.gauss_ax} needs {n_mesh} ranks, "
                    "one process per device: launch them with torchrun, or set "
                    "runtime.coordinator_address, num_processes and process_id")
            dev = multihost.local_device(dev)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            self.mesh = make_mesh(self.data_ax, self.gauss_ax, dev)
        self.device = dev
        if cfg.runtime.detect_anomaly:
            torch.autograd.set_detect_anomaly(True)
        seed = cfg.runtime.seed
        host_gen = torch.Generator().manual_seed(seed)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.model_path = cfg.dataset.model_path or "./output/run"
        os.makedirs(self.model_path, exist_ok=True)
        timings = {}

        # ---- scene
        t0 = time.perf_counter()
        info = load_scene_info(cfg.dataset.source_path, cfg.dataset.images, cfg.dataset.eval,
                               cfg.dataset.resolution, cfg.dataset.white_background)
        self.scene_info = info
        self.train_cameras = info.train_cameras
        self.test_cameras = info.test_cameras
        self.cameras_extent = info.nerf_normalization["radius"]
        # The canvas is the largest (H, W) of the training photos.
        self.H = max(c.height for c in self.train_cameras)
        self.W = max(c.width for c in self.train_cameras)
        if self.gauss_ax > 1:
            # One band of tile rows per gauss rank: pad the height so grid_y
            # divides (padded pixels have occluders_mask 0 and drop out of
            # every loss).
            quant = 16 * self.gauss_ax
            self.H = -(-self.H // quant) * quant
        self.train_views = ViewStore(self.train_cameras, self.H, self.W, dev)
        timings["scene_s"] = time.perf_counter() - t0

        # ---- Gaussian pool
        t0 = time.perf_counter()
        pts = info.point_cloud.points.astype(np.float32)
        d2 = knn_dist2(pts)
        timings["knn_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sky_pts, sky_radius, sky_center = seed_sky_points(pts, self.train_cameras, host_gen)
        sky_d2 = knn_dist2(sky_pts) if len(sky_pts) > 3 else np.full(len(sky_pts), 1e-4)
        timings["sky_seeding_s"] = time.perf_counter() - t0
        n_total = len(pts) + len(sky_pts)
        capacity = cfg.runtime.pool_capacity or int(n_total * cfg.runtime.pool_headroom)
        capacity = max(capacity, int(n_total * 1.25))  # never below what init needs
        capacity = -(-capacity // self.gauss_ax) * self.gauss_ax   # rows divide over gauss
        params_g, gstate = G.init_from_points(pts, d2, capacity, device=dev)
        params_g, gstate = G.augment_with_sky(params_g, gstate, sky_pts, sky_d2, sky_radius,
                                              sky_center)
        print(f"pool: {len(pts)} fg + {len(sky_pts)} sky Gaussians, capacity {capacity}")

        # ---- nets
        m = cfg.model
        self.mlp = MLPNet(m.envlight_sh_degree, m.sky_sh_degree, m.embeddings_dim,
                          generator=host_gen).to(dev)
        embeddings = torch.randn((len(self.train_cameras), m.embeddings_dim),
                                 generator=host_gen).to(dev)
        self.state = TS.init_train_state(params_g, gstate, self.mlp, embeddings)

        # Entry budget and row intervals from one probe of the per-view demand.
        rt = cfg.runtime
        rect_demand = iv_demand = None
        t0 = time.perf_counter()
        if rt.max_dup == 0 or (not rt.row_intervals and rt.row_intervals_auto):
            rect_demand, iv_demand = self._probe_entry_demand()
        timings["probe_s"] = time.perf_counter() - t0
        row_iv, max_dup = size_entry_budget(rt.max_dup, bool(rt.row_intervals),
                                            rt.row_intervals_auto, rect_demand, iv_demand)
        if rect_demand:
            cut = 1.0 - iv_demand / max(rect_demand, 1)
            print(f"row_intervals: interval cut {cut:.1%} -> "
                  f"{'on' if row_iv else 'off'} (rect demand {rect_demand}, interval "
                  f"demand {iv_demand}{', set by runtime.row_intervals' if rt.row_intervals else ''})")
        if rt.max_dup == 0:
            print(f"entry budget: measured demand -> max_dup={max_dup}")
        self.rcfg = RasterizerConfig(width=self.W, height=self.H, max_dup=max_dup,
                                     row_intervals=row_iv)
        self.bg_color = torch.tensor([1.0, 1.0, 1.0] if cfg.dataset.white_background
                                     else [0.0, 0.0, 0.0], device=dev)
        if self.mesh is not None:
            self.state = DP.shard_train_state(self.state, self.mesh)
            print(f"mesh: data={self.data_ax} x gauss={self.gauss_ax}, rank "
                  f"{self.mesh.d * self.gauss_ax + self.mesh.g} on {dev} "
                  f"({self.data_ax} cameras/step{', pool sharded' if self.gauss_ax > 1 else ''})")
        self.init_report = dict(
            n_fg=len(pts), n_sky=len(sky_pts), capacity=capacity, rect_demand=rect_demand,
            interval_demand=iv_demand, row_intervals=row_iv, max_dup=max_dup, **timings)

        # Log and file IO on rank 0 only; the other ranks log to devnull.
        self.log_path = os.path.join(self.model_path, "train_log.jsonl")
        self.logger = TrainLogger(self.log_path if self.is_main else os.devnull,
                                  tb_dir=self.model_path if rt.tensorboard and self.is_main
                                  else None)
        self.profiler = ProfilerWindow(rt.profile_steps if self.is_main else "",
                                       os.path.join(self.model_path, "profile"))
        if self.is_main:
            self._write_run_files()

    def _write_run_files(self):
        """The run's config, the SIBR camera manifest and the legacy cfg_args."""
        cfg = self.cfg
        with open(os.path.join(self.model_path, "relightable3DG-W_run.yaml"), "w") as f:
            json.dump(config_to_dict(cfg), f, indent=2, default=str)
        # SIBR-viewer camera manifest, so external viewers can load the scene.
        with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
            json.dump([camera_to_json(i, c) for i, c in
                       enumerate(self.train_cameras + self.test_cameras)], f)
        # Legacy cfg_args: an eval()-able Namespace repr with the reference's
        # ModelParams names, so the reference's render/metrics scripts load
        # this model directory.
        ns = ("Namespace(sh_degree=3, source_path={!r}, model_path={!r}, "
              "images={!r}, resolution={!r}, white_background={!r}, "
              "eval={!r}, data_device='cuda')").format(
            os.path.abspath(cfg.dataset.source_path or ""), os.path.abspath(self.model_path),
            cfg.dataset.images, cfg.dataset.resolution, cfg.dataset.white_background,
            cfg.dataset.eval)
        with open(os.path.join(self.model_path, "cfg_args"), "w") as f:
            f.write(ns)

    def _to_device(self, view: dict) -> dict:
        """A padded view with its camera matrices, image and masks on the device."""
        t = lambda a: torch.as_tensor(a, device=self.device)
        return dict(view, mats=view["cam"].matrices(self.device), image_t=t(view["image"]),
                    sky_t=t(view["sky_mask"]), occ_t=t(view["occluders_mask"]))

    # ------------------------------------------------------------------ training

    @staticmethod
    def _crossed(interval: int, prev: int, cur: int) -> bool:
        """True iff a multiple of `interval` lies in (prev, cur]."""
        return interval > 0 and (cur // interval) > (prev // interval)

    def _event(self, it: int, name: str, t0: float, **values):
        """Log a schedule event with its host time (after a device sync)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.logger.scalars(it, dict(event=name, ms=(time.perf_counter() - t0) * 1e3, **values))

    def train(self, iterations: int | None = None,
              save_iterations=(15_000, 20_000, 30_000, 40_000), log_every: int = 100,
              test_iterations=(7_000, 30_000)):
        cfg = self.cfg
        o = cfg.optimizer
        iterations = iterations or o.iterations
        view_stack: list[int] = []
        grad_threshold = o.densify_grad_threshold
        rng = np.random.RandomState(cfg.runtime.seed)
        t0 = time.time()
        warm = (0, t0)  # (iter, wall) after the first logged step
        viewer = None
        if cfg.runtime.viewer_port > 0 and self.multiprocess:
            print("viewer: disabled under multi-process training (a render request on one "
                  "rank would take it out of step with the others)")
        elif cfg.runtime.viewer_port > 0:
            viewer = ViewerServer(cfg.runtime.viewer_ip, cfg.runtime.viewer_port,
                                  protocol=cfg.runtime.viewer_protocol,
                                  verify=cfg.dataset.source_path, device=self.device)
            print(f"viewer: listening on {cfg.runtime.viewer_ip}:{viewer.port} "
                  f"({cfg.runtime.viewer_protocol})")

        B = self.data_ax if self.mesh is not None else 1
        prev_overflow = None
        it = 0
        try:
            while it < iterations:
                prev_it, it = it, it + B
                self.profiler.step(it)
                t_iter = time.perf_counter()
                with torch.profiler.record_function("trainer.iteration"):
                    # Binning-overflow healing, one step delayed: the previous
                    # step's overflow count is read before this step starts, so
                    # at most the step that overflowed (whose update was
                    # rejected) is lost; this one runs with the grown budget.
                    # The read waits for the previous step on the device.
                    if prev_overflow is not None:
                        with torch.profiler.record_function("trainer.overflow_read"):
                            n_over = int(prev_overflow)
                            if n_over > 0:
                                self._heal_binning_overflow(prev_it, n_over)
                        prev_overflow = None

                    picked = []
                    for _ in range(B):
                        if not view_stack:
                            view_stack = list(range(len(self.train_views)))
                        picked.append(view_stack.pop(rng.randint(len(view_stack))))
                    if self.mesh is None:
                        i = picked[0]
                        image, sky, occ = self.train_views.fetch(i)
                        draws = TS.make_draws(self.gen, self.mlp, cfg)
                        self.state, aux = TS.train_step(
                            self.state, self.train_views.mats[i], image, sky, occ,
                            self.train_cameras[i].uid, draws, self.bg_color, self.mlp, cfg,
                            self.rcfg, device=self.device)
                    else:
                        self.state, aux = self._dp_train_step(picked)
                    prev_overflow = aux.overflow

                    if viewer is not None:
                        try:
                            handle_viewer_request(viewer, _ViewerHost(self))
                        except Exception as e:  # a viewer hiccup must never stop training
                            print(f"viewer: request failed ({e!r}); dropping connection")
                            viewer.close_conn()

                    if self._crossed(log_every, prev_it, it) or prev_it == 0:
                        loss = float(aux.loss)  # the pull waits for the step
                        iter_ms = (time.perf_counter() - t_iter) * 1e3
                        if warm[0] == 0:
                            warm = (it, time.time())
                        steady = ((it - warm[0]) / max(time.time() - warm[1], 1e-9)
                                  if it > warm[0] else 1e3 / max(iter_ms, 1e-9))
                        rec = dict(loss=loss, l1=float(aux.l1), psnr=float(aux.psnr),
                                   alive=int(aux.num_alive), overflow=int(aux.overflow),
                                   iter_time=iter_ms, iters_per_s=steady)
                        self.logger.scalars(it, rec)
                        print(f"[{it}] loss={loss:.5f} psnr={rec['psnr']:.2f} "
                              f"alive={rec['alive']} {rec['iters_per_s']:.2f} it/s")

                    if (self.logger.tb is not None and not self.multiprocess
                            and self._crossed(log_every * 10, prev_it, it)):
                        p, alive = self.state.params["gaussians"], self.state.gauss_state.alive
                        for name in ("opacity", "roughness", "metalness"):
                            vals = torch.sigmoid(getattr(p, name)[alive, 0])
                            self.logger.histogram(it, name, vals.cpu().numpy())

                    # Densification schedule.
                    if it < o.densify_until_iter:
                        if (it > o.densify_from_iter
                                and self._crossed(o.densification_interval, prev_it, it)):
                            t_ev = time.perf_counter()
                            sized = it > o.opacity_reset_interval
                            # A sharded pool densifies whole: gathered over the
                            # gauss group, the single-device densify alike on
                            # every rank (same generator), then this rank's slice.
                            state = self._full_pool()
                            state, report = TS.densify_step(
                                state, grad_threshold, self.cameras_extent, cfg,
                                max_screen_size=20 if sized else None, generator=self.gen)
                            rep = {k: int(v) for k, v in report._asdict().items()}
                            self._event(it, "densify", t_ev, variant="sized" if sized else "plain",
                                        grad_threshold=grad_threshold, **rep)
                            grad_threshold = grad_thr_exp_scheduling(
                                it, o.densify_until_iter, o.densify_grad_threshold)
                            if rep["overflow"] > 0:
                                # Grow the pool (params, pool state, Adam moments) so
                                # the next round has room; the missed selections come
                                # back next round from fresh stats.
                                cap = state.gauss_state.alive.shape[0]
                                new_cap = -(-int(cap * 1.5) // self.gauss_ax) * self.gauss_ax
                                print(f"[{it}] pool overflow: {rep['overflow']} selected "
                                      f"Gaussians not allocated; growing pool {cap} -> {new_cap}")
                                t_ev = time.perf_counter()
                                state = TS.grow_train_state(state, new_cap)
                                self._event(it, "grow_pool", t_ev, capacity=new_cap)
                            self._set_full_state(state)
                        if (self._crossed(o.opacity_reset_interval, prev_it, it)
                                or (prev_it < o.densify_from_iter <= it)):
                            t_ev = time.perf_counter()
                            self.state = TS.reset_opacity_step(self.state)
                            self._event(it, "opacity_reset", t_ev)

                    if any(prev_it < s <= it for s in test_iterations) or it >= iterations:
                        t_ev = time.perf_counter()
                        self.evaluate_report(it)
                        self._event(it, "evaluate", t_ev)

                    if any(prev_it < s <= it for s in save_iterations) or it >= iterations:
                        t_ev = time.perf_counter()
                        self.save(it)
                        self._event(it, "save", t_ev)
        finally:
            if viewer is not None:
                viewer.close()
            self.profiler.close()
            self.logger.close()
        return self.state

    @torch.no_grad()
    def _probe_entry_demand(self) -> tuple[int, int]:
        """The scene's per-view entry demand, as the largest over up to 8 of the
        training cameras of the opacity-tightened tile-entry total, as plain
        rects and as per-row ellipse intervals. It sizes the entry budget and
        decides the row-interval auto-enable."""
        p, s = self.state.params["gaussians"], self.state.gauss_state
        xyz, scales, quats = G.get_xyz(p, s), G.get_scaling(p), G.get_rotation(p)
        op = G.get_opacity(p, s)[:, 0] * s.alive
        rects, ivs = [], []
        for cam in self.train_views.mats[:: max(len(self.train_views) // 8, 1)][:8]:
            pre = preprocess(xyz, scales, quats, cam.viewmat, cam.projmat, cam.tan_fovx,
                             cam.tan_fovy, self.W, self.H, 16, opacities=op)
            rects.append(int(pre.tiles_touched.sum()))
            ivs.append(int(row_intervals(pre, op)[0].sum()))
        return max(rects), max(ivs)

    def _heal_binning_overflow(self, it: int, n_over: int):
        """Grow the entry budget after a binning overflow (whose update the step
        rejected): demand = max_dup + n_over; take max(1.5x, 1.05 x demand),
        rounded up to 4096."""
        need = int((self.rcfg.max_dup + n_over) * 1.05)
        new_dup = max(int(self.rcfg.max_dup * 1.5), need)
        new_dup = (new_dup + 4095) // 4096 * 4096
        print(f"[{it}] binning overflow ({n_over} entries dropped, update REJECTED): "
              f"max_dup {self.rcfg.max_dup} -> {new_dup}")
        self.logger.scalars(it, dict(event="heal_binning_overflow", dropped=n_over,
                                     max_dup=new_dup))
        self.rcfg = self.rcfg._replace(max_dup=new_dup)

    def _full_pool(self) -> TS.TrainState:
        """COLLECTIVE under a gauss-sharded mesh: the full state, the pool
        gathered over this rank's gauss group; else the state itself."""
        return self.state if self.mesh is None else DP.gather_pool(self.state, self.mesh)

    def _set_full_state(self, state: TS.TrainState):
        """Take a full state: this rank's shard of it under a mesh."""
        self.state = state if self.mesh is None else DP.shard_train_state(state, self.mesh)

    def _dp_train_step(self, picked):
        """One data-parallel step over B = len(picked) training views: every
        rank draws all B images' StepDraws, in order, so the generators stay in
        step; data row d takes view picked[d] and draws d. The overflow is the
        max over all ranks, so every rank heals the entry budget alike."""
        canvases = [self.train_views.fetch(i, slot=d) for d, i in enumerate(picked)]
        st = lambda k: torch.stack([c[k] for c in canvases])
        mats = [self.train_views.mats[i] for i in picked]
        batch = DP.CameraBatch(
            *[torch.stack([getattr(m, f) for m in mats]) for f in
              ("viewmat", "projmat", "campos", "tan_fovx", "tan_fovy")],
            gt_image=st(0), sky_mask=st(1), occluders_mask=st(2),
            uid=torch.tensor([self.train_cameras[i].uid for i in picked], device=self.device))
        draws = [TS.make_draws(self.gen, self.mlp, self.cfg) for _ in picked]
        step = DP.make_dp_train_step(self.mlp, self.cfg, self.rcfg, self.mesh)
        state, metrics = step(self.state, batch, draws, self.bg_color)
        PC.all_reduce_(metrics.overflow, None, op=dist.ReduceOp.MAX)
        return state, metrics

    def _render_view(self, view: dict, emb: torch.Tensor):
        """Render one padded view under embedding `emb` [1, D] (no dropout)."""
        p = self.state.params
        m = self.cfg.model
        envl, sky_sh = functional_call(self.mlp, p["mlp"], (emb,))
        return render(p["gaussians"], self.state.gauss_state, envl[0], sky_sh, view["mats"],
                      self.rcfg, self.bg_color, view["sky_t"], m.envlight_sh_degree,
                      m.sky_sh_degree, m.specular, m.fix_sky, debug=False, device=self.device)

    def evaluate_report(self, it: int, n_train_views: int = 5):
        """In-training evaluation: render a few train cameras and every test
        camera, log PSNR / L1, and write render|GT panels to
        <model_path>/panels/iteration_N/. Test cameras render with the mean
        train embedding ("test_psnr_mean_emb"); then up to
        `runtime.eval_halffit_views` of them get a short left-half embedding
        fit from the mean embedding (min(optim_embeddings_test_iters, 60)
        steps) and their right-half masked PSNR is logged as
        "test_psnr_halffit", the split the evaluation protocol scores.
        Under a mesh every rank gathers the full state (a collective) and rank
        0 alone evaluates it."""
        if self.mesh is not None:
            full = self._full_pool()
            if not self.is_main:
                return
            kept, self.state = self.state, full
            try:
                return self._evaluate(it, n_train_views)
            finally:
                self.state = kept
        return self._evaluate(it, n_train_views)

    def _evaluate(self, it: int, n_train_views: int):
        emb = self.state.params["embeddings"]
        mean_emb = emb.mean(dim=0, keepdim=True)
        panel_dir = os.path.join(self.model_path, "panels", f"iteration_{it}")
        os.makedirs(panel_dir, exist_ok=True)
        test_views = ([self._to_device(v) for v in pad_cameras(self.test_cameras)[0]]
                      if self.test_cameras else [])
        chw = lambda x: x.movedim(-1, 0)
        for split, views, use_mean in (("train", self.train_views[:n_train_views], False),
                                       ("test", test_views, True)):
            psnrs, l1s = [], []
            for view in views:
                cam = view["cam"]
                with torch.no_grad():
                    out = self._render_view(view, mean_emb if use_mean else emb[cam.uid][None])
                img = torch.clamp(out.render, 0, 1)
                gt, occ = view["image_t"], view["occ_t"][..., None]
                psnrs.append(float(LO.psnr(chw(img * occ), chw(gt * occ))))
                l1s.append(float(LO.l1_loss(chw(img), chw(gt), mask=chw(occ.expand_as(img)))))
                panel = torch.cat([img, gt], dim=1).cpu().numpy()
                Image.fromarray((panel * 255).astype(np.uint8)).save(
                    os.path.join(panel_dir, f"{split}_{cam.image_name}.png"))
                self.logger.image(it, f"{split}/{cam.image_name}", panel)
            if psnrs:
                name = "test_psnr_mean_emb" if use_mean else f"{split}_psnr"
                rec = {name: float(np.mean(psnrs)), f"{split}_l1": float(np.mean(l1s))}
                self.logger.scalars(it, rec)
                print(f"[{it}] eval {split}: {name}={rec[name]:.2f} "
                      f"l1={rec[f'{split}_l1']:.4f} over {len(psnrs)} views")

        k = self.cfg.runtime.eval_halffit_views
        if test_views and k > 0:
            from .evaluation import optimize_test_embeddings

            sub = test_views[:k]
            emb_t = optimize_test_embeddings(
                self.state.params, self.state.gauss_state, self.mlp, sub, self.cfg, self.rcfg,
                mean_emb.expand(len(sub), -1),
                iters=min(self.cfg.optimizer.optim_embeddings_test_iters, 60),
                device=self.device)
            W2 = self.rcfg.width // 2
            ps = []
            for i, view in enumerate(sub):
                with torch.no_grad():
                    out = self._render_view(view, emb_t[i][None])
                img = torch.clamp(out.render, 0, 1)[:, W2:]
                gt, occ = view["image_t"][:, W2:], view["occ_t"][:, W2:, None]
                ps.append(float(LO.psnr(chw(img * occ), chw(gt * occ))))
            rec = {"test_psnr_halffit": float(np.mean(ps))}
            self.logger.scalars(it, rec)
            print(f"[{it}] eval test(half-fit {len(sub)} views): "
                  f"psnr={rec['test_psnr_halffit']:.2f}")

    # --------------------------------------------------------------- checkpoints

    def _iter_dir(self, sub: str, iteration: int) -> str:
        d = os.path.join(self.model_path, sub, f"iteration_{iteration}")
        os.makedirs(d, exist_ok=True)
        return d

    @torch.no_grad()
    def save(self, iteration: int):
        """Write the checkpoint of `iteration`. Under a mesh every rank gathers
        the full state (a collective), rank 0 writes, then all meet at a
        barrier."""
        state = self._full_pool()
        if not self.is_main:
            multihost.sync_processes(f"save_{iteration}")
            return
        p, s = state.params["gaussians"], state.gauss_state
        idx = torch.nonzero(s.alive).flatten()
        is_sky = s.is_sky[idx].cpu().numpy()
        np_ = lambda a: a[idx].cpu().numpy()
        xyz = np_(G.get_xyz(p, s))

        def take(a, sky_default):
            return np.where(is_sky[:, None], sky_default, np_(a))

        # Reference-compatible PLY: raw params, sentinels on the sky rows'
        # foreground-only attributes.
        fields: dict[str, np.ndarray] = {}
        fields["x"], fields["y"], fields["z"] = xyz.T
        alb = take(p.albedo, 1.0)
        for i in range(3):
            fields[f"albedo_{i}"] = alb[:, i]
        fields["opacity"] = np_(p.opacity)[:, 0]
        sc, rt = np_(p.scaling), np_(p.rotation)
        for i in range(3):
            fields[f"scale_{i}"] = sc[:, i]
        for i in range(4):
            fields[f"rot_{i}"] = rt[:, i]
        fields["roughness"] = take(p.roughness, 0.0)[:, 0]
        fields["metalness"] = take(p.metalness, 0.0)[:, 0]
        fields["is_sky"] = is_sky.astype(np.float32)
        n = len(idx)
        fields["sky_radius"] = np.full(n, float(p.sky_radius), np.float32)
        cen = s.sky_center.cpu().numpy()
        for i in range(3):
            fields[f"sky_gauss_center_{i}"] = np.full(n, cen[i], np.float32)
        ang = np.where(is_sky[:, None], np_(p.sky_angles), 0.0)
        fields["sky_angles_0"], fields["sky_angles_1"] = ang[:, 0], ang[:, 1]
        write_ply(os.path.join(self._iter_dir("point_cloud", iteration), "point_cloud.ply"),
                  fields)

        emb = state.params["embeddings"]
        np.savez(os.path.join(self._iter_dir("checkpoint_embeddings", iteration),
                              "embeddings_weights.npz"), weight=emb.cpu().numpy())
        with open(os.path.join(self._iter_dir("checkpoint_MLP", iteration),
                               "MLP_weights.npz"), "wb") as f:
            f.write(CK.mlp_to_bytes(state.params["mlp"]))

        envl_dir = self._iter_dir("envlights_sh", iteration)
        envl, _ = functional_call(self.mlp, state.params["mlp"], (emb,))
        envl = envl.cpu().numpy()
        for i, cam in enumerate(self.train_cameras):
            np.save(os.path.join(envl_dir, f"envlight_sh_{cam.image_name}.npy"), envl[i])

        np.savez(os.path.join(self._iter_dir("full_state", iteration), "state.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(CK.state_leaves(state))})
        multihost.sync_processes(f"save_{iteration}")

    def load_checkpoint(self, iteration: int = -1):
        """Warm start from a saved iteration (-1 = the latest): the full-state
        bundle when present (Adam moments too), else point_cloud.ply +
        embeddings + MLP weights with fresh Adam moments. Every rank reads the
        files (rank 0 wrote them before a barrier) and keeps its shard."""
        if iteration == -1:
            pc_dir = os.path.join(self.model_path, "point_cloud")
            iteration = max(int(d.split("_")[-1]) for d in os.listdir(pc_dir)
                            if d.startswith("iteration_"))
        full = os.path.join(self.model_path, "full_state", f"iteration_{iteration}",
                            "state.npz")
        if os.path.exists(full):
            return self.load_full_state(iteration)

        ply = os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}",
                           "point_cloud.ply")
        capacity = self.state.gauss_state.alive.shape[0] * (self.gauss_ax if self.mesh else 1)
        params_g, gstate = load_gaussians_ply(ply, capacity=capacity, device=self.device)
        emb = np.load(os.path.join(self.model_path, "checkpoint_embeddings",
                                   f"iteration_{iteration}", "embeddings_weights.npz"))["weight"]
        with open(os.path.join(self.model_path, "checkpoint_MLP", f"iteration_{iteration}",
                               "MLP_weights.npz"), "rb") as f:
            mlp_params = CK.mlp_from_bytes(f.read(), self.device)
        params = {"gaussians": params_g, "mlp": mlp_params,
                  "embeddings": torch.as_tensor(emb, device=self.device)}
        zeros = lambda: TS.tree_map(torch.zeros_like, params)
        opt = TS.AdamState(torch.zeros((), dtype=torch.int32, device=self.device), zeros(),
                           zeros())
        self._set_full_state(TS.TrainState(
            params, gstate, opt, torch.tensor(iteration, dtype=torch.int64, device=self.device)))
        return self.state

    def load_full_state(self, iteration: int):
        bundle = np.load(os.path.join(self.model_path, "full_state", f"iteration_{iteration}",
                                      "state.npz"))
        leaves = [bundle[f"leaf_{i}"] for i in range(len(bundle.files))]
        self._set_full_state(CK.state_from_leaves(leaves, self.device))
        return self.state


def load_gaussians_ply(path: str, capacity: int | None = None,
                       device: str | torch.device = "cpu"):
    """A reference-format point_cloud.ply -> a pool of `capacity` rows (default:
    the file's row count)."""
    v = read_ply(path)
    n = len(v["x"])
    capacity = capacity or n
    is_sky = v["is_sky"].astype(bool)
    xyz = np.stack([v["x"], v["y"], v["z"]], -1)
    d2 = np.ones(n)  # scales come from the file
    params, state = G.init_from_points(xyz.astype(np.float32), d2, capacity, device=device)

    def put(name, cols):
        return np.stack([v[f"{name}_{i}"] for i in range(cols)], -1).astype(np.float32)

    def fill(arr, val):
        a = np.zeros(tuple(arr.shape), np.float32)
        a[:n] = val
        return torch.as_tensor(a, device=device)

    params = params._replace(
        albedo=fill(params.albedo, put("albedo", 3)),
        opacity=fill(params.opacity, v["opacity"][:, None]),
        scaling=fill(params.scaling, put("scale", 3)),
        rotation=fill(params.rotation, put("rot", 4)),
        roughness=fill(params.roughness, v["roughness"][:, None]),
        metalness=fill(params.metalness, v["metalness"][:, None]),
        sky_angles=fill(params.sky_angles, put("sky_angles", 2)),
        sky_radius=torch.tensor(float(v["sky_radius"][0]), dtype=torch.float32, device=device),
    )
    center = np.array([v[f"sky_gauss_center_{i}"][0] for i in range(3)], np.float32)
    state = state._replace(
        is_sky=torch.as_tensor(np.pad(is_sky, (0, capacity - n)), device=device),
        sky_center=torch.as_tensor(center, device=device))
    return params, state
