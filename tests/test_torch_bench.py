"""The port's measurement scripts on the CPU, against the JAX repo's.

* `scripts/bench.py`: `build` gives the JAX `bench.build`'s scene bit for
  bit, and its entry budget and row-interval decision; the train mode's image
  and five gradients match `jax.grad` of the same loss on JAX's jnp path
  (ROADMAP's tolerance); `main` prints one JSON line in each mode, reports an
  overflowing budget without crashing, and refuses to run without a card
  unless --device=cpu is given.
* `scripts/stage_pie.py`: `sol_pct` equals JAX's; `measure_stage_pie` gives
  JAX's stage keys in each mode.
* `scripts/parity.py` and `scripts/bench_train_step.py` run once at a tiny
  size; the train-step bench sizes its budget as the JAX script does.
"""

import json
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench as jbench
from __graft_entry__ import _camera as jcamera
from relightable3dgaussians_w_tpu.models import gaussians as jG
from relightable3dgaussians_w_tpu.ops.preprocess import preprocess as jpreprocess
from relightable3dgaussians_w_tpu.ops.rasterize import rasterize as jrasterize
from scripts import stage_pie as jstage_pie

from relightable3dgaussians_w_torch.ops.rasterize import rasterize
from relightable3dgaussians_w_torch.scripts import bench, bench_train_step, parity, stage_pie
import _torch_threads

_torch_threads.share_cores()

N, RES = 2000, 64
GRAD_TOL = 5e-3
GROUPS = ("means", "scales", "quats", "opacities", "colors")
# JAX's stage keys (scripts/stage_pie.py measure_stage_pie), by mode.
PIE_KEYS = {"render": ["preprocess", "binning", "gather", "composite_fwd"],
            "train": ["preprocess", "binning", "gather", "composite_fwd", "composite_bwd",
                      "segsum_grads"]}
# Knob sets of `build`: isotropic and the anisotropic regime at 64^2 (interval
# cut under 15%: intervals stay off), and at 128^2 with scales[:, 0] x 32 (a
# 15%+ cut: on in train mode, off in render mode, where the packed and LOD
# knobs apply).
SCENES = {
    "iso": (RES, {"BENCH_ANISO": "1"}),
    "aniso8": (RES, {"BENCH_ANISO": "8"}),
    "aniso32_train": (128, {"BENCH_ANISO": "32"}),
    "aniso32_render": (128, {"BENCH_ANISO": "32", "BENCH_MODE": "render", "BENCH_PACKED": "1",
                             "BENCH_SKIP_ALPHA": "0.0625"}),
}
GRAD_SCENES = ("iso", "aniso32_train")


def jax_loss(cam, cfg):
    bg = jnp.zeros(3, jnp.float32)

    def f(*arrs):
        img, aux = jrasterize(*arrs, bg, cam, cfg)
        return jnp.sum(img) + jnp.sum(aux.alpha), img
    return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4), has_aux=True))


@pytest.fixture(scope="module")
def jax_ref():
    """Each scene's JAX `bench.build` output as numpy, and for GRAD_SCENES the
    jnp path's image and five gradients."""
    out = {}
    for name, (res, env) in SCENES.items():
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            arrs, cam, cfg = jbench.build(N, res, res)
        ref = {"arrs": [np.asarray(a) for a in arrs],
               "cam": [np.asarray(x) for x in cam], "cfg": cfg}
        if name in GRAD_SCENES:
            grads, img = jax_loss(cam, cfg)(*arrs)
            ref["img"], ref["grads"] = np.asarray(img), [np.asarray(g) for g in grads]
        out[name] = ref
    return out


def port_build(monkeypatch, name):
    res, env = SCENES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return bench.build(N, res, res, device="cpu")


@pytest.mark.parametrize("name", list(SCENES))
def test_build_matches_jax(jax_ref, monkeypatch, name):
    ref = jax_ref[name]
    arrs, cam, cfg = port_build(monkeypatch, name)
    for got, want in zip(list(arrs) + list(cam), ref["arrs"] + ref["cam"]):
        np.testing.assert_array_equal(got.numpy(), want)
    jcfg = ref["cfg"]
    assert (cfg.max_dup, cfg.row_intervals, cfg.skip_alpha, cfg.packed_rgb) == (
        jcfg.max_dup, jcfg.row_intervals, jcfg.skip_alpha, jcfg.packed_rgb)
    want_iv = {"aniso32_train": True}.get(name, False)   # both sides of the 15% rule
    assert cfg.row_intervals == want_iv


@pytest.mark.parametrize("name", GRAD_SCENES)
def test_train_mode_matches_jax(jax_ref, monkeypatch, name):
    """The port's image and gradients of image.sum() + alpha.sum() against the
    jnp path's: under 0.1% of pixels off by more than 1e-3, median under 1e-5;
    each gradient's max |delta| / max |ref| under 5e-3."""
    ref = jax_ref[name]
    arrs, cam, cfg = port_build(monkeypatch, name)
    leaves = [a.requires_grad_(True) for a in arrs]
    img, aux = rasterize(*leaves, torch.zeros(3), cam, cfg, device="cpu")
    grads = torch.autograd.grad(img.sum() + aux.alpha.sum(), leaves)
    assert int(aux.overflow) == 0
    err = np.abs(img.detach().double().numpy() - ref["img"])
    assert (err > 1e-3).mean() < 1e-3 and np.median(err) < 1e-5, (err.max(), np.median(err))
    for group, got, want in zip(GROUPS, grads, ref["grads"]):
        rel = np.abs(got.double().numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert rel < GRAD_TOL, (group, rel)


@pytest.mark.parametrize("pie,e2e", [
    ({"preprocess": 1.0, "binning": 2.0, "gather": 0.5, "composite_fwd": 3.0}, 10.0),
    ({"preprocess": 4.0, "binning": 5.0, "gather": 0.0, "composite_fwd": 3.0,
      "composite_bwd": 2.5, "segsum_grads": 0.25}, 10.0),   # the cap
])
def test_sol_pct_matches_jax(pie, e2e):
    for vjp in (None, 1.5):
        assert stage_pie.sol_pct(pie, e2e, vjp) == jstage_pie.sol_pct(pie, e2e, vjp)


@pytest.mark.parametrize("mode", ["train", "render"])
def test_stage_pie_keys(monkeypatch, mode):
    monkeypatch.setenv("BENCH_MODE", mode)
    arrs, cam, cfg = port_build(monkeypatch, "iso")
    pie = stage_pie.measure_stage_pie(arrs, cam, cfg, torch.zeros(3), mode=mode)
    assert list(pie) == PIE_KEYS[mode]
    assert all(v >= 0.0 for v in pie.values()), pie


# (mode, extra env): the train and render modes, packed serving, and the
# verify skill's overflow probe scaled down (a budget under the ~2,400-entry
# demand).
MAIN_CASES = {"train": ("train", {}), "render": ("render", {}),
              "render_packed": ("render", {"BENCH_PACKED": "1"}),
              "overflow_probe": ("train", {"BENCH_MAX_DUP": "1024"})}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_bench_main_prints_one_line(monkeypatch, capsys, case):
    mode, env = MAIN_CASES[case]
    for k, v in dict(BENCH_N=str(N), BENCH_RES=str(RES), BENCH_ITERS="1", BENCH_MODE=mode,
                     **env).items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    kind = "render" if mode == "render" else "fwd_bwd"
    assert rec["metric"] == f"splat_{kind}_pixels_per_s_{N}g_{RES}x{RES}"
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert rec["unit"] == "pixels/s/chip" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 100e6)
    x = rec["extra"]
    unit = "frame" if mode == "render" else "iter"
    assert x[f"ms_per_{unit}"] > 0 and (mode == "train" or x["fps"] > 0)
    assert x[f"device_ms_per_{unit}"] is None and x["card"] is None and x["backend"] == "cpu"
    assert x["packed_rgb"] == (case == "render_packed")
    assert list(x["stage_pie_ms"]) == PIE_KEYS[mode]
    assert 0.0 < x["sol_pct"] <= 100.0 and "stage_pie_error" not in x
    if case == "overflow_probe":
        assert x["max_dup"] == 1024 and x["overflow_entries"] > 0
    else:
        assert x["overflow_entries"] == 0


def test_bench_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])


def test_parity_runs_on_the_cpu(capsys):
    rep = parity.run(n=N, res=RES, device="cpu")
    assert json.loads(capsys.readouterr().out.strip()) == rep
    assert rep["ok"] and rep["overflow"] == 0 and rep["image_max_abs"] == 0.0
    assert all(rep[f"grad_{g}_rel"] == 0.0 for g in GROUPS)


def test_bench_train_step_runs_on_the_cpu(capsys):
    ms = bench_train_step.main(N, RES, 1, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    rec = json.loads(lines[-1])
    assert ms > 0 and rec["ms_per_iter"] == ms and rec["backend"] == "cpu"
    assert math.isfinite(rec["loss"]) and rec["overflow"] == 0
    # The JAX script's draws and budget: entries of the pool at init x 1.3.
    rng = np.random.RandomState(0)
    pts = np.stack([rng.uniform(-2.5, 2.5, N), rng.uniform(-2.5, 2.5, N),
                    rng.uniform(1.0, 10.0, N)], -1).astype(np.float32)
    p, _ = jG.init_from_points(pts, np.full(N, 5e-5, np.float32), 4096)
    cam = jcamera(RES, RES)
    total = int(jax.jit(lambda m, s, q, o: jnp.sum(jpreprocess(
        m, s, q, cam.viewmat, cam.projmat, cam.tan_fovx, cam.tan_fovy, RES, RES, 16,
        opacities=o).tiles_touched))(p.xyz, jnp.exp(p.scaling), p.rotation,
                                     jax.nn.sigmoid(p.opacity)))
    assert lines[0] == f"n={N} res={RES} entries~{total} max_dup={bench.entry_budget(total, 1.3)}"
