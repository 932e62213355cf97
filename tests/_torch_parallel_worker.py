"""Rank worker for tests/test_torch_parallel.py: one rank of a gloo group on the CPU.

    python _torch_parallel_worker.py <group> <rank> <world> <rendezvous file> <in.npz> <out dir>
    python _torch_parallel_worker.py cli <rank> <world> <port> <data dir> <model dir>

Imports torch and the port only. Each rank runs every check of its group and
writes what the tests read to <out dir>/<group>_rank<r>.npz:

* g2 (2 ranks): the gauss-sharded render (bitwise against the single-device
  render, its gradients, the overflow of a 1-row budget), and the data = 2
  step (per-image gradients, the stepped state, a forced overflow);
* g4 (4 ranks, data 2 x gauss 2): the fused per-image gradients, the
  collective pull of the full state, and densify on the sharded pool against
  the single-device densify of the gathered pool;
* cli: `cli.train.main` as one rank of data 2 x gauss 2 over tcp, 24
  iterations and a save, then a resume of 8 iterations from that checkpoint.
"""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from relightable3dgaussians_w_torch import checkpoint as CK  # noqa: E402
from relightable3dgaussians_w_torch import train_step as TS  # noqa: E402
from relightable3dgaussians_w_torch.config import Config  # noqa: E402
from relightable3dgaussians_w_torch.models.nets import MLPNet  # noqa: E402
from relightable3dgaussians_w_torch.ops import rasterize as R  # noqa: E402
from relightable3dgaussians_w_torch.parallel import data_parallel as DP  # noqa: E402
from relightable3dgaussians_w_torch.parallel import gauss_shard as GS  # noqa: E402
from relightable3dgaussians_w_torch.parallel import multihost  # noqa: E402
from relightable3dgaussians_w_torch.parallel.mesh import make_mesh  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=90)
DENSIFY_THRESHOLD = 1e-7    # low enough that the stepped pool clones and splits


def rel(got, want):
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))


def t(a):
    return torch.as_tensor(np.asarray(a))


def camera(z):
    return R.CameraMatrices(*[t(z[k]) for k in ("viewmat", "projmat", "campos", "tanf", "tanf")])


def gauss_render_checks(z, out):
    """The gauss-sharded render on this group (D ranks) against the
    single-device render of the full scene."""
    D, d = dist.get_world_size(), dist.get_rank()
    names = ("means", "scales", "quats", "opac", "colors")
    full = [t(z[k]).requires_grad_(True) for k in names]
    bg, cam = t(z["bg"]), camera(z)
    cfg = R.RasterizerConfig(width=int(z["W"]), height=int(z["H"]), max_dup=1 << 15)
    n = full[0].shape[0]
    probe = torch.zeros((n, 2), requires_grad=True)
    ref, ref_aux = R.rasterize(*full, bg, cam, cfg, device="cpu", mean2d_probe=probe)
    w = t(z["w_img"])
    (ref * w).sum().backward()

    m = n // D
    loc = [x.detach()[d * m:(d + 1) * m].clone().requires_grad_(True) for x in full]
    lprobe = torch.zeros((m, 2), requires_grad=True)
    img, aux = GS.rasterize_gauss_sharded(*loc, bg, cam, cfg, dist.group.WORLD,
                                          mean2d_probe=lprobe)
    # Every rank computes the loss from the full image: the ranks' losses sum
    # to D times it.
    ((img * w).sum() / D).backward()
    out["gs_image"] = img.detach().numpy()
    out["gs_bitwise"] = bool(torch.equal(img, ref) and torch.equal(aux.alpha, ref_aux.alpha)
                             and torch.equal(aux.radii, ref_aux.radii))
    out["gs_overflow"] = int(aux.overflow)
    out["gs_grad_err"] = np.array([rel(a.grad, b.grad[d * m:(d + 1) * m])
                                   for a, b in zip(loc + [lprobe], full + [probe])])
    _, _, over1 = GS.render_gauss_sharded(*[x.detach() for x in loc], bg, cam, cfg,
                                          dist.group.WORLD, rows_per_band=1)
    out["gs_overflow_rows1"] = int(over1)


def dp_inputs(z):
    """The step's inputs carried over from the JAX package's setup."""
    state = CK.state_from_leaves([z[f"leaf_{i}"] for i in range(CK.N_STATE_LEAVES)])
    B = z["gt"].shape[0]
    batch = DP.CameraBatch(
        *[torch.stack([t(z[k])] * B) for k in ("viewmat", "projmat", "campos", "tanf", "tanf")],
        gt_image=t(z["gt"]), sky_mask=torch.ones(z["gt"].shape[:3]),
        occluders_mask=torch.ones(z["gt"].shape[:3]), uid=t(z["uid"]))
    draws = [TS.StepDraws(t(z["noise"][i]), t(z["keep"][i]), t(z["dirs"][i])) for i in range(B)]
    cfg = Config()
    cfg.optimizer.reg_normal_from_iter = 0
    rcfg = R.RasterizerConfig(width=64, height=64, max_dup=1 << 14)
    return state, batch, draws, cfg, rcfg, MLPNet()


def per_image(state, batch, draws, cfg, rcfg, mlp, mesh, out):
    """This rank's per-image loss and gradient leaves (its pool rows)."""
    loss, aux, grads, probe = DP.make_per_image_grads(mlp, cfg, rcfg, mesh)(
        state, batch, draws[mesh.d], torch.zeros(3))
    out["pi_loss"] = float(loss)
    out["pi_overflow"] = int(aux["overflow"])
    for i, g in enumerate(TS.tree_leaves(grads) + [probe]):
        out[f"pi_grad_{i}"] = g.detach().numpy()


def g2(z, out):
    gauss_render_checks(z, out)
    mesh = make_mesh(data=2, gauss=1, device="cpu")
    state, batch, draws, cfg, rcfg, mlp = dp_inputs(z)
    per_image(state, batch, draws, cfg, rcfg, mlp, mesh, out)
    new, metrics = DP.make_dp_train_step(mlp, cfg, rcfg, mesh)(state, batch, draws,
                                                                torch.zeros(3))
    out["step_loss"] = float(metrics.loss)
    for i, a in enumerate(CK.state_leaves(new)):
        out[f"step_leaf_{i}"] = a
    # Every image overflows: both microsteps rejected, the step still +2.
    new, metrics = DP.make_dp_train_step(mlp, cfg, rcfg._replace(max_dup=64), mesh)(
        state, batch, draws, torch.zeros(3))
    out["overflow_kept"] = all(
        torch.equal(a, b) for a, b in zip(TS.tree_leaves((new.params, new.opt_state)),
                                          TS.tree_leaves((state.params, state.opt_state))))
    out["overflow_step"] = int(new.step) - int(state.step)
    out["overflow_metric"] = int(metrics.overflow)


def g4(z, out):
    mesh = make_mesh(data=2, gauss=2, device="cpu")
    full, batch, draws, cfg, rcfg, mlp = dp_inputs(z)
    state = DP.shard_train_state(full, mesh)
    per_image(state, batch, draws, cfg, rcfg, mlp, mesh, out)

    pulled = multihost.host_replicated(state, mesh)
    out["pull_equal"] = all(np.array_equal(a, b.numpy()) for a, b in zip(
        TS.tree_leaves(pulled), TS.tree_leaves(full)))

    new, _ = DP.make_dp_train_step(mlp, cfg, rcfg, mesh)(state, batch, draws, torch.zeros(3))
    gathered = DP.gather_pool(new, mesh)
    gen = lambda: torch.Generator().manual_seed(7)
    # The trainer's densify of a sharded pool: gather, the single-device densify
    # with the same generator on every rank, keep this rank's slice.
    dens, report = TS.densify_step(DP.gather_pool(new, mesh), DENSIFY_THRESHOLD, 2.0, cfg,
                                   generator=gen())
    back = DP.gather_pool(DP.shard_train_state(dens, mesh), mesh)
    ref, ref_report = TS.densify_step(gathered, DENSIFY_THRESHOLD, 2.0, cfg, generator=gen())
    out["densify_bitwise"] = all(torch.equal(a, b) for a, b in zip(
        TS.tree_leaves(back), TS.tree_leaves(ref)))
    out["densify_selected"] = int(report.n_cloned) + int(report.n_split)
    out["densify_report_equal"] = all(int(a) == int(b) for a, b in zip(report, ref_report))


def cli(rank, world, port, data_dir, model_dir):
    from relightable3dgaussians_w_torch.cli import train as cli_train

    common = [f"dataset.source_path={data_dir}", f"dataset.model_path={model_dir}",
              "optimizer.densify_from_iter=8", "optimizer.densification_interval=12",
              "optimizer.opacity_reset_interval=20", "optimizer.reg_normal_from_iter=0",
              "runtime.pool_capacity=2048", "runtime.max_dup=16384",
              "runtime.data_parallel=2", "runtime.gauss_shards=2",
              f"runtime.coordinator_address=127.0.0.1:{port}",
              f"runtime.num_processes={world}", f"runtime.process_id={rank}", "--device=cpu"]
    tr = cli_train.main(common + ["optimizer.iterations=24"])
    assert tr.multiprocess and tr.mesh is not None and tr.is_main == (rank == 0)
    tr = cli_train.main(common + ["optimizer.iterations=8", "model.load_iteration=24"])
    print(f"[rank {rank}] done step {int(tr.state.step)}", flush=True)


def main():
    torch.set_num_threads(1)
    group, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    if group == "cli":
        return cli(rank, world, *sys.argv[4:7])
    rdv, inp, out_dir = sys.argv[4:7]
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
                            timeout=TIMEOUT)
    out = {}
    {"g2": g2, "g4": g4}[group](dict(np.load(inp)), out)
    np.savez(os.path.join(out_dir, f"{group}_rank{rank}.npz"), **out)
    multihost.sync_processes("done", timeout_s=TIMEOUT.total_seconds())
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
