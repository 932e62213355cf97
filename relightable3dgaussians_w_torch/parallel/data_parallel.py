"""Camera-batched data-parallel training over a data x gauss mesh of ranks.

Port of the JAX package's `parallel/data_parallel.py`. A batch of B = `data`
cameras goes one to each data row; every rank renders and differentiates its
row's camera; the per-image gradients are gathered over `data`, and every rank
then applies the B sequential Adam microsteps in image order, identically, as
the reference applies one Adam step per image. Pool rows and their Adam moments
are sharded over `gauss` (rank g keeps rows [g n / G, (g + 1) n / G), the nets
and embeddings whole); with gauss > 1 the render is the gauss-sharded one
(`gauss_shard.py`) in forward and backward, and the pool is never gathered for
a step.

Gradient semantics (`make_per_image_grads`), exact up to reduction order:

* data only: each rank's own `train_step.loss_and_grads`;
* fused data x gauss: the raster function is this rank's band of the
  gauss-sharded render plus an all-gather of the bands over the gauss group;
  the loss is computed with the pool group (`train_step.core_loss`), so each
  rank's loss is the global loss / G and the pool grads are this shard's
  single-device grads; the net, embedding and sky-radius grads are summed over
  the gauss group (JAX's automatic psum of a replicated input's cotangent).

The step counter advances by B; an image whose render overflowed has its
microstep rejected (parameters and moments kept), and contributes no
densification statistics.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch

from ..config import Config
from ..models import gaussians as G
from ..models.nets import MLPNet
from ..ops.rasterize import CameraMatrices, RasterizeAux, RasterizerConfig
from ..train_step import (StepDraws, TrainState, adam_update, loss_and_grads, make_lr_tree,
                          tree_leaves, tree_map)
from . import collectives as C
from .gauss_shard import check_pool, default_rows_per_band, rasterize_gauss_shard_local
from .mesh import Mesh

# Pool fields that are not per-row: replicated on every rank.
REPLICATED_FIELDS = ("sky_radius", "sky_center")


class CameraBatch(NamedTuple):
    """Stacked per-camera arrays; row i is data row i's camera."""
    viewmat: torch.Tensor         # [B, 4, 4]
    projmat: torch.Tensor         # [B, 4, 4]
    campos: torch.Tensor          # [B, 3]
    tan_fovx: torch.Tensor        # [B]
    tan_fovy: torch.Tensor        # [B]
    gt_image: torch.Tensor        # [B, H, W, 3]
    sky_mask: torch.Tensor        # [B, H, W]
    occluders_mask: torch.Tensor  # [B, H, W]
    uid: torch.Tensor             # [B]

    def camera(self, i: int) -> CameraMatrices:
        return CameraMatrices(self.viewmat[i], self.projmat[i], self.campos[i],
                              self.tan_fovx[i], self.tan_fovy[i])


def map_pool(state: TrainState, pool_fn, rep_fn=lambda a: a) -> TrainState:
    """`pool_fn` over the per-row pool leaves (Gaussian params, pool state, their
    Adam moments), `rep_fn` over the rest."""
    def nt(t):
        return type(t)(**{k: rep_fn(v) if k in REPLICATED_FIELDS else pool_fn(v)
                          for k, v in t._asdict().items()})

    def leaf(k, v):
        if k == "gaussians":
            return nt(v)
        return {n: rep_fn(a) for n, a in v.items()} if k == "mlp" else rep_fn(v)

    def tree(p):   # keeps the dicts' key order, and so tree_leaves' order
        return {k: leaf(k, v) for k, v in p.items()}

    opt = state.opt_state
    return TrainState(tree(state.params), nt(state.gauss_state),
                      type(opt)(rep_fn(opt.count), tree(opt.mu), tree(opt.nu)),
                      rep_fn(state.step))


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's slice of a full state: pool rows [g n / G, (g + 1) n / G),
    everything else whole, on the rank's device."""
    n = state.gauss_state.alive.shape[0]
    if n % mesh.gauss:
        raise ValueError(f"pool of {n} rows does not divide over gauss={mesh.gauss}")
    rows = n // mesh.gauss
    lo = mesh.g * rows
    return map_pool(state, lambda a: a[lo:lo + rows].to(mesh.device).clone(),
                    lambda a: a.to(mesh.device))


def gather_pool(state: TrainState, mesh: Mesh) -> TrainState:
    """COLLECTIVE over the gauss group: the full state from every rank's slice
    (one all-gather of the pool leaves packed as float32 columns, which holds
    their bools and floats exactly)."""
    if mesh.gauss == 1:
        return state
    leaves = []
    map_pool(state, leaves.append)
    n = leaves[0].shape[0]
    flat = torch.cat([a.reshape(n, -1).to(torch.float32) for a in leaves], dim=1)
    full = C.all_gather(flat, mesh.gauss_group)
    parts = iter(torch.split(full, [a[0].numel() if a.ndim > 1 else 1 for a in leaves], dim=1))
    return map_pool(state, lambda a: next(parts).reshape(-1, *a.shape[1:]).to(a.dtype))


def gauss_sharded_raster_fn(mesh: Mesh, rows_per_band: int):
    """raster_fn for `render_from_inputs`: this rank's band of the gauss-sharded
    render, the bands all-gathered over the gauss group into the full image;
    radii and depth are this shard's."""
    group = mesh.gauss_group

    def raster_fn(xyz, scales, quats, opacity, colors, bg, cam, rcfg, mean2d_probe=None,
                  active=None):
        img_b, alpha_b, overflow, num_entries, radius, depth = rasterize_gauss_shard_local(
            xyz, scales, quats, opacity, colors, bg, cam, rcfg, group, rows_per_band,
            mean2d_probe=mean2d_probe, active=active)
        aux = RasterizeAux(radii=radius, visibility=radius > 0, depth=depth,
                           alpha=C.all_gather(alpha_b, group)[: rcfg.height],
                           num_entries=num_entries, overflow=overflow)
        return C.all_gather(img_b, group)[: rcfg.height], aux
    return raster_fn


def make_per_image_grads(mlp: MLPNet, cfg: Config, rcfg: RasterizerConfig, mesh: Mesh):
    """per_image_grads(state, batch, draws, bg) -> (loss, aux, param_grads,
    probe_grad) of this rank's data row's camera (`batch` row mesh.d, `draws`
    its StepDraws): the single-device gradients when gauss == 1, the fused
    data x gauss gradients (this shard's pool rows, the global nets) when the
    pool is sharded."""
    dev = mesh.device

    def per_image_grads(state: TrainState, batch: CameraBatch, draws: StepDraws, bg):
        i = mesh.d
        args = (batch.camera(i), batch.gt_image[i], batch.sky_mask[i], batch.occluders_mask[i],
                batch.uid[i], draws, bg, mlp, cfg, rcfg)
        if mesh.gauss == 1:
            return loss_and_grads(state, *args, device=dev)
        n_loc = state.gauss_state.alive.shape[0]
        check_pool(n_loc, mesh.gauss, rcfg)
        raster_fn = gauss_sharded_raster_fn(mesh, default_rows_per_band(n_loc, mesh.gauss))
        loss, aux, grads, probe = loss_and_grads(state, *args, device=dev, raster_fn=raster_fn,
                                                 pool_group=mesh.gauss_group)
        # Replicated leaves got this rank's part of their gradient: sum them.
        reduce = lambda g: C.all_reduce_(g, mesh.gauss_group)
        grads = dict(grads, mlp={k: reduce(v) for k, v in grads["mlp"].items()},
                     embeddings=reduce(grads["embeddings"]),
                     gaussians=grads["gaussians"]._replace(
                         sky_radius=reduce(grads["gaussians"].sky_radius)))
        return C.all_reduce_(loss.clone(), mesh.gauss_group), aux, grads, probe
    return per_image_grads


def _gather_images(values: list[torch.Tensor], group) -> list[torch.Tensor]:
    """COLLECTIVE over the data group: each tensor of this rank's image, stacked
    over the batch ([B, ...]), in one all-gather of float32 columns."""
    flat = torch.cat([v.reshape(-1).to(torch.float32) for v in values])[None]
    full = C.all_gather(flat, group)
    parts = torch.split(full, [v.numel() for v in values], dim=1)
    return [p.reshape(-1, *v.shape).to(v.dtype) for p, v in zip(parts, values)]


def apply_microsteps(state: TrainState, like, leaves_b, ok_b, cfg: Config):
    """Sequential Adam microsteps, image by image, from B gradients taken at
    the pre-batch parameters: B lr-sized moves per B images, as the reference's
    one step per image. leaves_b: the gradient leaves (in `tree_leaves(like)`
    order), each [B, ...]. An image that overflowed (ok_b False) has wrong
    gradients: its microstep keeps the old parameters and moments. Returns
    (params, AdamState, step + B)."""
    params, opt, count = state.params, state.opt_state, state.step
    for i in range(ok_b.shape[0]):
        it = iter([g[i] for g in leaves_b])
        g = tree_map(lambda _: next(it), like)
        updates, new_opt = adam_update(g, opt)
        lrs = make_lr_tree(params, count, cfg.optimizer)
        new_params = tree_map(lambda p, u, lr: p + (-lr * u), params, updates, lrs)
        sel = lambda new, old, ok=ok_b[i]: tree_map(lambda a, b: torch.where(ok, a, b), new, old)
        params, opt, count = sel(new_params, params), sel(new_opt, opt), count + 1
    return params, opt, count


def add_batch_stats(gstate: G.GaussianState, probe_b, radii_b, ok_b,
                    rcfg: RasterizerConfig) -> G.GaussianState:
    """Densification statistics of a batch: the probe grads [B, n, 2] summed
    over the images that did not overflow, in the reference's NDC units; seen
    by any of them; their largest radius."""
    okf = ok_b.to(torch.float32)
    ndc = (probe_b * okf[:, None, None]).sum(dim=0) * torch.tensor(
        [0.5 * rcfg.width, 0.5 * rcfg.height], dtype=torch.float32, device=probe_b.device)
    visible = ((radii_b > 0) & ok_b[:, None]).any(dim=0)
    max_radii = (radii_b * ok_b[:, None]).amax(dim=0)
    return G.add_densification_stats(gstate, ndc, visible, max_radii)


def make_dp_train_step(mlp: MLPNet, cfg: Config, rcfg: RasterizerConfig, mesh: Mesh):
    """step(state, batch, draws, bg) -> (new state, metrics), on this rank's
    slice of the state. `draws` holds the B images' StepDraws (data row d uses
    draws[d]); metrics are the batch's mean loss, l1 and psnr, its per-image
    losses [B], its largest overflow and the global count of live Gaussians."""
    per_image_grads = make_per_image_grads(mlp, cfg, rcfg, mesh)

    def step(state: TrainState, batch: CameraBatch, draws, bg):
        B = mesh.data
        if batch.uid.shape[0] != B or len(draws) != B:
            raise ValueError(f"a batch of {batch.uid.shape[0]} cameras and {len(draws)} draws "
                             f"on a mesh with data={B}")
        loss, aux, grads, probe = per_image_grads(state, batch, draws[mesh.d], bg)
        with torch.no_grad():
            leaves = tree_leaves(grads)
            img = [loss, aux["l1"].detach(), aux["psnr"].detach(), aux["radii"], probe, *leaves]
            losses, l1s, psnrs, radii_b, probe_b, *leaves_b = _gather_images(img, mesh.data_group)
            overflow_b = C.all_gather(aux["overflow"].reshape(1), mesh.data_group)
            ok_b = overflow_b == 0

            params, opt, count = apply_microsteps(state, grads, leaves_b, ok_b, cfg)
            gstate = add_batch_stats(state.gauss_state, probe_b, radii_b, ok_b, rcfg)

            metrics = SimpleNamespace(
                loss=losses.mean(), losses=losses, l1=l1s.mean(), psnr=psnrs.mean(), overflow=overflow_b.amax(),
                num_alive=C.all_reduce_(G.num_alive(gstate), mesh.gauss_group))
        return TrainState(params, gstate, opt, count), metrics
    return step
