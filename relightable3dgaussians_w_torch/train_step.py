"""The training step: render -> loss stack -> Adam with per-leaf learning rates.

Port of the JAX package's `train_step.py` (`TrainState`, `StepAux`,
`make_lr_tree`, `make_leaf_inputs`, `core_loss`, `forward_loss`, the update of
`_apply_update`, the opacity reset). One call of `train_step`:

1. the illumination MLP (with its dropout keep-mask) and per-Gaussian shading
   make the rasterizer's leaf inputs (`make_leaf_inputs`);
2. the fused 13-channel render and the loss stack give the loss (`core_loss`);
3. autograd gives the gradient of every parameter leaf and of the mean2d probe,
   through the compositor backward and the gather transpose (CUDA kernels on the
   card, plain versions on the CPU);
4. Adam (optax's `scale_by_adam` with eps = 1e-15, bias-corrected) and the
   per-leaf learning rates update the parameters, and the densification
   statistics take the probe gradient in NDC units (x 0.5 W, 0.5 H).

An entry-budget overflow makes the render, and so every gradient, wrong: the
step then keeps the old parameters, Adam moments, Adam count and densification
statistics (selected on the device, no host sync) and only advances `step`.
Between steps the trainer calls the density-control steps: `densify_step`
(clone, split, prune, with the Adam moments' rows kept in step),
`reset_opacity_step` and `grow_train_state` (pool growth).

Each part of the step runs inside a `torch.profiler` range ("train_step.
to_device", ".leaf_inputs", ".render", ".losses", ".backward", ".adam"; the
rasterizer and the two backward kernels add their own), so a profile of the
step splits its time by stage. Inside ".leaf_inputs" the MLP and the shading
have theirs ("nets.mlp", "renderer.shading"). The backward runs on autograd's
thread: the device span of ".backward", opened on the calling thread, holds
almost none of its kernels (the two backward Functions' ranges hold theirs), so
the backward's device time is what runs between the ".losses" and ".adam"
ranges' device spans.

The JAX step's three random draws (envlight noise, dropout keep-mask, R+ sample
directions) come in as one `StepDraws`; `make_draws` makes them from an
explicit `torch.Generator`, so the step never reads torch's global RNG. The
split-dispatch variants of the JAX step work around XLA scheduling and have no
counterpart here.

Parameter trees are dicts and NamedTuples of tensors: {"gaussians":
GaussianParams, "mlp": {parameter name: tensor} (the MLPNet's own names, applied
with `torch.func.functional_call`), "embeddings": [M, D]}.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.func import functional_call

from .config import Config
from .device import resolve_device
from .models import gaussians as G
from .models.nets import KEEP_PROB, MLPNet
from .ops.rasterize import CameraMatrices, RasterizerConfig
from .renderer import RenderInputs, render_from_inputs, render_inputs
from .utils import losses as LO
from .utils.general import expon_lr

SPATIAL_LR_SCALE = 5.0  # the reference's hard-coded spatial_lr_scale
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15
N_ENVL_DIRS = 10        # R+ sample directions per step


class AdamState(NamedTuple):
    count: torch.Tensor   # [] int32 updates applied
    mu: Any               # first moments, shaped like the params
    nu: Any               # second moments


class TrainState(NamedTuple):
    params: Any           # {"gaussians": GaussianParams, "mlp": {...}, "embeddings": [M, D]}
    gauss_state: G.GaussianState
    opt_state: AdamState
    step: torch.Tensor    # [] integer


class StepAux(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    psnr: torch.Tensor
    radii: torch.Tensor
    visibility: torch.Tensor
    overflow: torch.Tensor
    num_alive: torch.Tensor


class StepDraws(NamedTuple):
    noise: torch.Tensor   # [(deg+1)**2, 3] envlight noise, N(0, 1) * 0.025
    keep: torch.Tensor    # [1, dense] bool dropout keep-mask of the MLP's first layer
    dirs: torch.Tensor    # [N_ENVL_DIRS, 3] R+ sample directions, uniform in [-1, 1]^3


# ------------------------------------------------------------------ trees


def tree_map(fn, *trees):
    """fn over the tensor leaves of dicts, tuples and NamedTuples of equal
    structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, tuple):
        mapped = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*mapped) if hasattr(t0, "_fields") else tuple(mapped)
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


# ------------------------------------------------------------------ set-up


def make_draws(generator: torch.Generator, mlp: MLPNet, cfg: Config) -> StepDraws:
    """One step's random draws from `generator`, on its device."""
    dev = generator.device
    deg = cfg.model.envlight_sh_degree
    noise = torch.randn(((deg + 1) ** 2, 3), generator=generator, device=dev) * 0.025
    keep = torch.rand((1, mlp.dense[0].out_features), generator=generator, device=dev) < KEEP_PROB
    dirs = torch.rand((N_ENVL_DIRS, 3), generator=generator, device=dev) * 2.0 - 1.0
    return StepDraws(noise, keep, dirs)


def init_train_state(gaussians: G.GaussianParams, gauss_state: G.GaussianState,
                     mlp: MLPNet, embeddings: torch.Tensor) -> TrainState:
    """A state at step 0 with zero Adam moments; the MLP's weights are copied."""
    params = {"gaussians": gaussians,
              "mlp": {k: v.detach().clone() for k, v in mlp.named_parameters()},
              "embeddings": embeddings}
    zeros = lambda: tree_map(torch.zeros_like, params)
    dev = embeddings.device
    opt = AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros())
    return TrainState(params, gauss_state, opt, torch.zeros((), dtype=torch.int64, device=dev))


# ------------------------------------------------------------------ optimizer


def make_lr_tree(params, step: torch.Tensor, ocfg):
    """Per-leaf learning rates (float32 scalars on `step`'s device)."""
    o = ocfg
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=step.device)
    xyz_lr = expon_lr(step, o.position_lr_init * SPATIAL_LR_SCALE,
                      o.position_lr_final * SPATIAL_LR_SCALE,
                      lr_delay_mult=o.position_lr_delay_mult,
                      max_steps=o.position_lr_max_steps)
    net_lr = torch.where(step >= 20_000, f32(0.0002), f32(o.mlp_lr))
    emb_lr = torch.where(step >= 20_000, f32(0.0002), f32(o.embeddings_lr))
    g_lrs = G.GaussianParams(
        xyz=xyz_lr,
        albedo=f32(o.albedo_lr),
        opacity=f32(o.opacity_lr),
        scaling=f32(o.scaling_lr * SPATIAL_LR_SCALE),
        rotation=f32(o.rotation_lr),
        roughness=f32(o.roughness_lr),
        metalness=f32(o.metalness_lr),
        sky_angles=xyz_lr,
        sky_radius=f32(o.sky_radius_lr),
    )
    return {"gaussians": g_lrs, "mlp": {k: net_lr for k in params["mlp"]},
            "embeddings": emb_lr}


def adam_update(grads, opt_state: AdamState, b1: float = ADAM_B1, b2: float = ADAM_B2,
                eps: float = ADAM_EPS):
    """optax.scale_by_adam: (updates mu_hat / (sqrt(nu_hat) + eps), new state),
    in optax's op order."""
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, opt_state.mu)
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, opt_state.nu)
    count = torch.where(opt_state.count < torch.iinfo(torch.int32).max,
                        opt_state.count + 1, opt_state.count)
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)
    updates = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
    return updates, AdamState(count, mu, nu)


# ------------------------------------------------------------------ loss


def make_leaf_inputs(params, gauss_state: G.GaussianState, mlp: MLPNet, cam: CameraMatrices,
                     cam_uid, draws: StepDraws, cfg: Config):
    """Params -> rasterizer leaf inputs: embedding lookup, MLP (with the dropout
    keep-mask), envlight noise, activations and shading. Returns
    (RenderInputs, envlight_sh) with the envlight SH before the noise (the R+
    loss reads it)."""
    e = params["embeddings"][cam_uid][None]
    envlight_sh, sky_sh = functional_call(mlp, params["mlp"], (e,), {"keep": draws.keep})
    envlight_sh = envlight_sh[0]
    m = cfg.model
    inp = render_inputs(params["gaussians"], gauss_state, envlight_sh + draws.noise, sky_sh, cam,
                        envlight_sh_degree=m.envlight_sh_degree, sky_sh_degree=m.sky_sh_degree,
                        specular=m.specular, fix_sky=m.fix_sky, debug=False)
    return inp, envlight_sh


def core_loss(inp: RenderInputs, envlight_sh, gauss_state: G.GaussianState, mean2d_probe,
              cam: CameraMatrices, gt_image, sky_mask, occluders_mask, draws: StepDraws,
              step, cfg: Config, rcfg: RasterizerConfig, bg_color,
              device: str | torch.device = "cuda", raster_fn=None, pool_group=None):
    """Rasterize the leaf inputs and evaluate the loss stack. Returns (loss, aux
    dict).

    raster_fn: optional stand-in for `rasterize` (`render_from_inputs`).
    pool_group: the process group the pool rows are sharded over, when this
    runs as one rank of the gauss-sharded step (`parallel/data_parallel.py`,
    JAX's pool_axis). Every term then has global semantics (the image terms
    see the gathered full image, the pool-row regularizers sum over the group)
    and the loss returned is the global loss divided by the group's size, so
    that the ranks' losses sum to the global one and every gradient, through
    the collectives' transposes, is the single-device gradient."""
    with torch.profiler.record_function("train_step.render"):
        out = render_from_inputs(inp, gauss_state, cam, rcfg, bg_color, sky_mask, debug=False,
                                 mean2d_probe=mean2d_probe, device=device, raster_fn=raster_fn)
    with torch.profiler.record_function("train_step.losses"):
        return _loss_stack(out, inp, envlight_sh, gauss_state, gt_image, sky_mask,
                           occluders_mask, draws, step, cfg, pool_group)


def _loss_stack(out, inp: RenderInputs, envlight_sh, gauss_state: G.GaussianState, gt_image,
                sky_mask, occluders_mask, draws: StepDraws, step, cfg: Config, pool_group=None):
    o = cfg.optimizer
    # Each rank of a pool group holds the same global loss: scale every term by
    # 1 / size so the ranks' losses sum to it once.
    iw = 1.0 / dist.get_world_size(pool_group) if pool_group is not None else 1.0

    # Losses work in the reference's [C, H, W] layout.
    chw = lambda x: x.movedim(-1, 0)
    image = chw(out.render)
    gt = chw(gt_image)
    occ3 = torch.broadcast_to(occluders_mask[None], image.shape)
    sky3 = torch.broadcast_to(sky_mask[None], image.shape)

    l1 = LO.l1_loss(image, gt, mask=occ3)
    ssim_v = 1.0 - LO.ssim(image, gt, mask=occ3)
    loss = iw * (l1 * (1 - o.lambda_dssim) + o.lambda_dssim * ssim_v)

    # Sky-region BRDF suppression: 1 - sky_mask selects the sky.
    diff_c = chw(out.diffuse_color)
    spec_c = chw(out.specular_color)
    loss = loss + iw * o.lambda_sky_brdf * (
        LO.l1_loss(diff_c, torch.zeros_like(diff_c), mask=1 - sky3)
        + LO.l1_loss(spec_c, torch.zeros_like(spec_c), mask=1 - sky3))

    if o.lambda_normal > 0:
        rn = chw(out.normal) * occ3 * sky3
        rs = chw(out.normal_ref) * occ3 * sky3
        ncl = o.lambda_normal * torch.mean(1.0 - torch.sum(rn * rs, dim=0))
        loss = loss + iw * torch.where(step > o.reg_normal_from_iter, ncl, 0.0)

    # Environment-light R+ constraint, added unweighted (lambda_envlight only
    # switches it on).
    if o.lambda_envlight > 0:
        loss = loss + iw * LO.envl_sh_loss(draws.dirs, envlight_sh,
                                           cfg.model.envlight_sh_degree)

    if o.lambda_scale > 0:
        loss = loss + iw * o.lambda_scale * LO.min_scale_loss(
            inp.scales, out.radii, gauss_state.is_sky, pool_group=pool_group)

    if o.lambda_sky_gauss > 0:
        dl = o.lambda_sky_gauss * LO.depth_loss_gaussians(
            out.gauss_depth, gauss_state.is_sky, out.visibility_filter, pool_group=pool_group)
        loss = loss + iw * torch.where(step > o.reg_sky_gauss_depth_from_iter, dl, 0.0)

    psnr = LO.psnr(image * occ3, gt * occ3)
    aux = dict(l1=l1, psnr=psnr, radii=out.radii, visibility=out.visibility_filter,
               overflow=out.overflow)
    return loss, aux


def forward_loss(params, gauss_state: G.GaussianState, mean2d_probe, mlp: MLPNet,
                 cam: CameraMatrices, gt_image, sky_mask, occluders_mask, cam_uid,
                 draws: StepDraws, step, cfg: Config, rcfg: RasterizerConfig, bg_color,
                 device: str | torch.device = "cuda", raster_fn=None, pool_group=None):
    """The whole loss stack from the parameters. Returns (loss, aux dict).
    raster_fn and pool_group as in `core_loss`."""
    with torch.profiler.record_function("train_step.leaf_inputs"):
        inp, envlight_sh = make_leaf_inputs(params, gauss_state, mlp, cam, cam_uid, draws, cfg)
    return core_loss(inp, envlight_sh, gauss_state, mean2d_probe, cam, gt_image, sky_mask,
                     occluders_mask, draws, step, cfg, rcfg, bg_color, device=device,
                     raster_fn=raster_fn, pool_group=pool_group)


# ------------------------------------------------------------------ step


@torch.no_grad()
def apply_update(state: TrainState, param_grads, probe_grad, loss, aux, cfg: Config,
                 rcfg: RasterizerConfig):
    """Adam + per-leaf learning rates, densification statistics, and the
    rejection of the whole update when the entry budget overflowed."""
    updates, new_opt = adam_update(param_grads, state.opt_state)
    lrs = make_lr_tree(state.params, state.step, cfg.optimizer)
    new_params = tree_map(lambda p, u, lr: p + (-lr * u), state.params, updates, lrs)

    # The reference's NDC-unit mean2D gradient: pixel-space probe grads x (W/2, H/2).
    ndc_grad = probe_grad * torch.tensor([0.5 * rcfg.width, 0.5 * rcfg.height],
                                         dtype=torch.float32, device=probe_grad.device)
    new_gstate = G.add_densification_stats(state.gauss_state, ndc_grad, aux["visibility"],
                                           aux["radii"])

    ok = aux["overflow"] == 0
    sel = lambda new, old: tree_map(lambda a, b: torch.where(ok, a, b), new, old)
    new_params = sel(new_params, state.params)
    new_opt = sel(new_opt, state.opt_state)
    new_gstate = sel(new_gstate, state.gauss_state)

    new_state = TrainState(new_params, new_gstate, new_opt, state.step + 1)
    step_aux = StepAux(loss=loss, l1=aux["l1"].detach(), psnr=aux["psnr"].detach(),
                       radii=aux["radii"], visibility=aux["visibility"],
                       overflow=aux["overflow"], num_alive=G.num_alive(new_gstate))
    return new_state, step_aux


def loss_and_grads(state: TrainState, cam: CameraMatrices, gt_image, sky_mask, occluders_mask,
                   cam_uid, draws: StepDraws, bg_color, mlp: MLPNet, cfg: Config,
                   rcfg: RasterizerConfig, device: str | torch.device = "cuda",
                   raster_fn=None, pool_group=None):
    """(loss, aux, parameter-gradient tree, probe gradient [N, 2]) of one step,
    detached from autograd, with every input already on `device`; raster_fn
    and pool_group as in `core_loss` (with a pool group the loss and gradients
    are this rank's)."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
    n = state.gauss_state.alive.shape[0]
    probe = torch.zeros((n, 2), dtype=torch.float32, device=device, requires_grad=True)
    loss, aux = forward_loss(params, state.gauss_state, probe, mlp, cam, gt_image, sky_mask,
                             occluders_mask, cam_uid, draws, state.step, cfg, rcfg, bg_color,
                             device=device, raster_fn=raster_fn, pool_group=pool_group)
    leaves = tree_leaves(params) + [probe]
    with torch.profiler.record_function("train_step.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # Drop the step's autograd graph here (the loss and the loss stack's
        # l1 and psnr hold it): its release takes host time, which the step's
        # return would otherwise spend outside every range.
        loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
    grads = iter([torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)])
    param_grads = tree_map(lambda _: next(grads), params)
    return loss, aux, param_grads, next(grads)


def train_step(state: TrainState, cam: CameraMatrices, gt_image, sky_mask, occluders_mask,
               cam_uid, draws: StepDraws, bg_color, mlp: MLPNet, cfg: Config,
               rcfg: RasterizerConfig, device: str | torch.device = "cuda"):
    """One training step. Returns (new TrainState, StepAux).

    Args:
        gt_image: [H, W, 3]; sky_mask: [H, W], 1 = not sky; occluders_mask:
            [H, W], 1 = pixel counts in the image losses.
        cam_uid: index of the camera's appearance embedding.
        draws: this step's random draws (`make_draws`).
        mlp: the MLPNet architecture; its weights come from state.params["mlp"].
        device: where to run; inputs are moved there. "cuda" (the default)
            raises when CUDA is absent.
    """
    dev = resolve_device(device)
    to = lambda x: x.to(dev)
    with torch.profiler.record_function("train_step.to_device"):
        state = tree_map(to, state)
        cam = CameraMatrices(*[to(x) for x in cam])
        draws = StepDraws(*[to(x) for x in draws])
        gt_image, sky_mask, occluders_mask, bg_color = (
            to(x) for x in (gt_image, sky_mask, occluders_mask, bg_color))
    loss, aux, param_grads, probe_grad = loss_and_grads(
        state, cam, gt_image, sky_mask, occluders_mask, cam_uid, draws, bg_color, mlp, cfg, rcfg,
        device=dev)
    with torch.profiler.record_function("train_step.adam"):
        return apply_update(state, param_grads, probe_grad, loss, aux, cfg, rcfg)


def grow_train_state(state: TrainState, new_capacity: int) -> TrainState:
    """Pad the Gaussian params, the pool state and both Adam moments to
    `new_capacity` rows of zeros (what fresh rows would carry)."""
    params_g, gstate = G.grow(state.params["gaussians"], state.gauss_state, new_capacity)

    def grow_moments(m):
        return dict(m, gaussians=G.GaussianParams(
            *[G.pad_rows(a, new_capacity) for a in m["gaussians"]]))

    opt = state.opt_state._replace(mu=grow_moments(state.opt_state.mu),
                                   nu=grow_moments(state.opt_state.nu))
    return TrainState(dict(state.params, gaussians=params_g), gstate, opt, state.step)


def densify_step(state: TrainState, grad_threshold: float, extent: float, cfg: Config,
                 max_screen_size=None, generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None):
    """Densify and prune the pool, with the Gaussian rows of both Adam moments
    kept in step (min opacity 0.005). max_screen_size None is the JAX package's
    `densify_step`, 20 its `densify_step_sized` (after the first opacity
    reset). Returns (new TrainState, DensifyReport)."""
    opt = state.opt_state
    params_g, gstate, (mu_g, nu_g), report = G.densify_and_prune(
        state.params["gaussians"], state.gauss_state,
        (opt.mu["gaussians"], opt.nu["gaussians"]), grad_threshold, 0.005, extent,
        max_screen_size, percent_dense=cfg.optimizer.percent_dense, generator=generator,
        noise=noise)
    new_opt = opt._replace(mu=dict(opt.mu, gaussians=mu_g), nu=dict(opt.nu, gaussians=nu_g))
    return TrainState(dict(state.params, gaussians=params_g), gstate, new_opt,
                      state.step), report


def reset_opacity_step(state: TrainState) -> TrainState:
    """Clamp every opacity to <= 0.01 and zero its Adam moments."""
    opt = state.opt_state
    params_g, (mu_g, nu_g) = G.reset_opacity(
        state.params["gaussians"], (opt.mu["gaussians"], opt.nu["gaussians"]))
    new_opt = opt._replace(mu=dict(opt.mu, gaussians=mu_g), nu=dict(opt.nu, gaussians=nu_g))
    return TrainState(dict(state.params, gaussians=params_g), state.gauss_state, new_opt,
                      state.step)
