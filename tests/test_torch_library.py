"""The torch port's library modules against the JAX package, on the CPU.

Same numpy inputs through both packages: the point-light BSDF op set (outputs
1e-5 of the largest value, input gradients 5e-3, both diffuse models), the
legacy cubemap light (face selection bitwise, face coordinates 1e-6; the mip
chain and split-sum shading from JAX's own Monte Carlo draws 1e-5 at base
resolution 32, with 512 / 128 samples instead of 4096 / 1024), the Radiance
.hdr reader (bitwise against OpenCV's decode) and `load_hdr_cubemap`, the
Morton-order approximate k-NN (codes and sort order equal, distances 1e-6
relative, with and without a mask), the COLMAP convert CLI (the same `colmap`
command lines, recorded by a stub on PATH) and the tune CLI (the same
trials.jsonl; one real objective on the CPU). The JAX references are jitted
and built once per module.
"""

import functools
import json
import os
import stat
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from relightable3dgaussians_w_tpu.cli import convert as jconvert
from relightable3dgaussians_w_tpu.cli import tune as jtune
from relightable3dgaussians_w_tpu.models import light_cubemap as jcube
from relightable3dgaussians_w_tpu.ops import bsdf as jbsdf
from relightable3dgaussians_w_tpu.ops import knn as jknn

from relightable3dgaussians_w_torch.cli import convert, tune
from relightable3dgaussians_w_torch.models import light_cubemap as cube
from relightable3dgaussians_w_torch.ops import bsdf, knn
from relightable3dgaussians_w_torch.utils import hdr

from test_trainer_e2e import make_dataset
import _torch_threads

_torch_threads.share_cores()

N = 256
CUBE_RES = 32
DIFFUSE_SAMPLES, SPECULAR_SAMPLES = 512, 128


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ------------------------------------------------------------------ BSDF


def _bsdf_inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.uniform(0.05, 0.95, s).astype(np.float32)
    pos = rng.normal(size=(N, 3)).astype(np.float32)
    nrm = _unit(rng, N)
    view_pos = np.array([0.3, 2.0, 4.0], np.float32)
    light_pos = np.array([-2.0, 3.0, 1.0], np.float32)
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
    return dict(kd=f(N, 3), arm=f(N, 3), pos=pos, nrm=nrm, view_pos=view_pos,
                light_pos=light_pos, wo=unit(view_pos - pos), wi=unit(light_pos - pos),
                smooth_nrm=nrm + 0.2 * _unit(rng, N), smooth_tng=_unit(rng, N),
                perturbed_nrm=_unit(rng, N) * np.array([0.3, 0.3, 1.0], np.float32),
                img=rng.uniform(0, 3, (8, 8, 3)).astype(np.float32),
                target=rng.uniform(0, 3, (8, 8, 3)).astype(np.float32),
                matrix=rng.normal(size=(4, 4)).astype(np.float32),
                weights=rng.normal(size=(N, 3)).astype(np.float32))


LOSSES = [(loss, tm) for loss in ("l1", "mse", "smape", "relmse")
          for tm in ("none", "log_srgb")]


def _bsdf_outputs(m, x, grads):
    """Every op of the library on the inputs `x`; with `grads`, also the
    gradients of the weighted pbr_bsdf (both modes), the shading normal and
    the losses. `m` is either package's module, `grads(fn, args)` its
    gradient."""
    wo, wi = x["wo"], x["wi"]
    rough = x["arm"][..., 1:2]
    out = {
        "lambert": m.lambert(x["nrm"], wi),
        "frostbite": m.frostbite(x["nrm"], wi, wo, rough),
        "phong": m.phong(x["nrm"], wo, wi, 8.0),
        "ndf_ggx": m.ndf_ggx(rough ** 2, m._dot(x["nrm"], wi)),
        "masking_smith": m.masking_smith(rough ** 2, m._dot(x["nrm"], wi),
                                         m._dot(x["nrm"], wo)),
        "pbr_specular": m.pbr_specular(x["kd"], x["nrm"], wo, wi, rough),
        "xfm_points": m.xfm_points(x["pos"], x["matrix"]),
        "xfm_vectors": m.xfm_vectors(x["nrm"], x["matrix"]),
    }
    for two_sided in (False, True):
        for opengl in (False, True):
            out[f"normal_{two_sided}_{opengl}"] = m.prepare_shading_normal(
                x["pos"], x["view_pos"], x["perturbed_nrm"], x["smooth_nrm"], x["smooth_tng"],
                x["nrm"], two_sided_shading=two_sided, opengl=opengl)
    for mode in (0, 1):
        out[f"pbr_bsdf_{mode}"] = m.pbr_bsdf(x["kd"], x["arm"], x["pos"], x["nrm"],
                                             x["view_pos"], x["light_pos"], bsdf=mode)
        out[f"pbr_bsdf_{mode}_grads"] = grads(
            lambda *a: (m.pbr_bsdf(*a, bsdf=mode) * x["weights"]).sum(),
            [x[k] for k in ("kd", "arm", "pos", "nrm", "view_pos", "light_pos")])
    out["normal_grads"] = grads(
        lambda *a: (m.prepare_shading_normal(*a) * x["weights"]).sum(),
        [x[k] for k in ("pos", "view_pos", "perturbed_nrm", "smooth_nrm", "smooth_tng",
                        "nrm")])
    for loss, tm in LOSSES:
        out[f"loss_{loss}_{tm}"] = m.image_loss(x["img"], x["target"], loss, tm)
        out[f"loss_{loss}_{tm}_grads"] = grads(lambda a, b: m.image_loss(a, b, loss, tm),
                                               [x["img"], x["target"]])
    return out


def _torch_grads(fn, args):
    args = [a.detach().requires_grad_(True) for a in args]
    return list(torch.autograd.grad(fn(*args), args))


@pytest.fixture(scope="module")
def bsdf_ref():
    x = _bsdf_inputs()
    jx = jax.tree.map(jnp.asarray, x)
    jgrads = lambda fn, args: list(jax.grad(fn, argnums=tuple(range(len(args))))(*args))
    want = jax.device_get(jax.jit(lambda x: _bsdf_outputs(jbsdf, x, jgrads))(jx))
    got = _bsdf_outputs(bsdf, {k: _t(v) for k, v in x.items()}, _torch_grads)
    return got, want


BSDF_GROUPS = {
    "pbr_bsdf_0": (["pbr_bsdf_0"], ["pbr_bsdf_0_grads"]),
    "pbr_bsdf_1": (["pbr_bsdf_1"], ["pbr_bsdf_1_grads"]),
    "normal": ([f"normal_{a}_{b}" for a in (False, True) for b in (False, True)],
               ["normal_grads"]),
    "ops": (["lambert", "frostbite", "phong", "ndf_ggx", "masking_smith", "pbr_specular",
             "xfm_points", "xfm_vectors"], []),
    "losses": ([f"loss_{a}_{b}" for a, b in LOSSES], [f"loss_{a}_{b}_grads" for a, b in LOSSES]),
}


@pytest.mark.parametrize("group", list(BSDF_GROUPS))
def test_bsdf_matches_jax(bsdf_ref, group):
    got, want = bsdf_ref
    values, grads = BSDF_GROUPS[group]
    for k in values:
        assert np.abs(np.asarray(want[k])).max() > 0, k
        assert _rel(got[k], want[k]) < 1e-5, k
    for k in grads:
        for g, w in zip(got[k], want[k], strict=True):
            assert np.abs(np.asarray(w)).max() > 0, k
            assert _rel(g, w) < 5e-3, (k, tuple(g.shape))


# ------------------------------------------------------------------ cubemap light


def _cube_base():
    rng = np.random.RandomState(3)
    base = rng.uniform(0.0, 1.0, (6, CUBE_RES, CUBE_RES, 3)).astype(np.float32)
    base[2, 4:9, 10:15] = 20.0   # a bright patch on +y
    return base


def _jax_draws(n_levels):
    uni = lambda seed, n: np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n, 2)))
    return uni(0, DIFFUSE_SAMPLES), [uni(i, SPECULAR_SAMPLES) for i in range(n_levels)]


def _fewer_samples(mp, module):
    """build_mips' Monte Carlo sample counts cut to DIFFUSE_SAMPLES /
    SPECULAR_SAMPLES (defaults 4096 / 1024) in `module`."""
    mp.setattr(module, "diffuse_cubemap", functools.partial(module.diffuse_cubemap,
                                                            n_samples=DIFFUSE_SAMPLES))
    mp.setattr(module, "specular_cubemap", functools.partial(module.specular_cubemap,
                                                             n_samples=SPECULAR_SAMPLES))


@pytest.fixture(scope="module")
def cube_ref():
    """JAX's mips and shading, compiled at XLA's optimization level 0, which
    rounds each operation as eager JAX and the port do: at
    level 0's roughness 0.08 the GGX sample's 1 + (a^2 - 1) u, contracted into
    an FMA by the optimizing compiler, moves the prefiltered texels by ~3e-5
    of the largest (jitted against eager JAX)."""
    base = _cube_base()
    rng = np.random.RandomState(4)
    n = 500
    shade_in = dict(positions=rng.normal(size=(n, 3)).astype(np.float32),
                    normals=_unit(rng, n), kd=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                    ks=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                    view_pos=np.array([0.5, 1.0, 5.0], np.float32),
                    fg_lut=rng.uniform(0, 1, (16, 16, 2)).astype(np.float32))
    def run(base, s):
        mips = jcube.build_mips(base)
        return mips, {spec: jcube.shade_cubemap(mips, s["positions"], s["normals"], s["kd"],
                                                s["ks"], s["view_pos"], specular=spec,
                                                fg_lut=s["fg_lut"]) for spec in (False, True)}

    with pytest.MonkeyPatch.context() as mp:
        _fewer_samples(mp, jcube)
        mips, shaded = jax.device_get(jax.jit(run, compiler_options={
            "xla_backend_optimization_level": 0})(jnp.asarray(base),
                                                  jax.tree.map(jnp.asarray, shade_in)))
    return dict(base=base, mips=mips, shaded=shaded, shade_in=shade_in)


def test_dir_to_cube_matches_jax():
    rng = np.random.RandomState(5)
    d = np.concatenate([rng.normal(size=(4000, 3)),
                        # axis ties and axis-aligned directions
                        np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1], [-1, -1, 0], [0, 0, -1],
                                  [0, -2, 0], [3, 0, 0]])]).astype(np.float32)
    jf, ju, jv = jax.device_get(jax.jit(jcube.dir_to_cube)(jnp.asarray(d)))
    f, u, v = cube.dir_to_cube(_t(d))
    np.testing.assert_array_equal(f.numpy(), jf)
    assert set(np.unique(jf)) == set(range(6))
    np.testing.assert_allclose(u.numpy(), ju, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=1e-6)
    for face in range(6):   # cube_to_dir inverts dir_to_cube on each face
        x, y = _t(rng.uniform(-0.9, 0.9, 50).astype(np.float32)), _t(rng.uniform(
            -0.9, 0.9, 50).astype(np.float32))
        ff, uu, vv = cube.dir_to_cube(cube.cube_to_dir(face, x, y))
        assert (ff == face).all()
        np.testing.assert_allclose(uu.numpy(), (x.numpy() + 1) / 2, atol=1e-6)
        np.testing.assert_allclose(vv.numpy(), (y.numpy() + 1) / 2, atol=1e-6)


def test_build_mips_matches_jax(cube_ref, monkeypatch):
    """Base 32 -> levels 32, 16 (GGX prefilter at roughness 0.08 and 1.0) and
    the 16^2 irradiance, from JAX's uniform draws."""
    _fewer_samples(monkeypatch, cube)
    diffuse_u, specular_u = _jax_draws(2)
    mips = cube.build_mips(_t(cube_ref["base"]), diffuse_u=diffuse_u, specular_u=specular_u)
    want = cube_ref["mips"]
    assert [m.shape[1] for m in mips.specular] == [32, 16]
    for got, w in zip(mips.specular + (mips.diffuse,), tuple(want.specular) + (want.diffuse,)):
        assert _rel(got, w) < 1e-5
    # the default draws come from a seeded generator: the same mips twice
    a = cube.specular_cubemap(_t(cube_ref["base"])[:, ::4, ::4], 0.3, n_samples=64, seed=5)
    b = cube.specular_cubemap(_t(cube_ref["base"])[:, ::4, ::4], 0.3, n_samples=64, seed=5)
    assert torch.equal(a, b)


@pytest.mark.parametrize("specular", [False, True])
def test_shade_cubemap_matches_jax(cube_ref, specular):
    want = cube_ref["mips"]
    mips = cube.CubemapLightMips(tuple(_t(m) for m in want.specular), _t(want.diffuse))
    s = {k: _t(v) for k, v in cube_ref["shade_in"].items()}
    got = cube.shade_cubemap(mips, s["positions"], s["normals"], s["kd"], s["ks"],
                             s["view_pos"], specular=specular, fg_lut=s["fg_lut"])
    assert _rel(got, cube_ref["shaded"][specular]) < 1e-5


# ------------------------------------------------------------------ HDR


def _hdr_image(h, w, seed):
    rng = np.random.RandomState(seed)
    img = np.exp(rng.uniform(-6, 6, (h, w, 3))).astype(np.float32)
    img[0, :3] = 0.0                                  # zero pixels
    img[1, :] = img[1, :1]                            # a run
    return img


@pytest.mark.parametrize("case", ["rle", "flat", "narrow", "ours"])
def test_hdr_reader_matches_opencv(tmp_path, case):
    """cv2 writes the file (run-length encoded; flat; 5 wide, which is never
    encoded) or `hdr.write_hdr` does; `read_hdr` equals cv2's decode bitwise."""
    cv2 = pytest.importorskip("cv2")
    img = _hdr_image(12, 5 if case == "narrow" else 40, 6)
    path = str(tmp_path / "env.hdr")
    if case == "ours":
        hdr.write_hdr(path, img)
    else:
        flags = ([cv2.IMWRITE_HDR_COMPRESSION, cv2.IMWRITE_HDR_COMPRESSION_NONE]
                 if case == "flat" else [])
        assert cv2.imwrite(path, img[..., ::-1], flags)
    want = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)[..., ::-1]
    got = hdr.read_hdr(path)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)
    # 8-bit mantissas under one exponent per pixel
    assert (np.abs(got - img) <= img.max(axis=-1, keepdims=True) * 2 ** -7).all()


def test_load_hdr_cubemap_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    hdr_path = str(tmp_path / "env.hdr")
    hdr.write_hdr(hdr_path, _hdr_image(16, 32, 7))
    png_path = str(tmp_path / "env.png")
    Image.fromarray(np.random.RandomState(8).randint(0, 256, (16, 32, 3), np.uint8)).save(
        png_path)
    for path in (hdr_path, png_path):
        # jitted: the file is read while tracing, the lookup compiles once
        want = np.asarray(jax.jit(lambda: jcube.load_hdr_cubemap(path, res=8))())
        got = cube.load_hdr_cubemap(path, res=8, device="cpu")
        assert got.shape == (6, 8, 8, 3)
        assert _rel(got, want) < 1e-5
    with pytest.raises(ValueError, match="OpenCV"):
        cube.load_hdr_cubemap(str(tmp_path / "env.exr"), device="cpu")


# ------------------------------------------------------------------ k-NN


@pytest.mark.parametrize("masked", [False, True])
def test_knn_dist2_morton_matches_jax(masked):
    """Clustered points (many equal Morton codes, so the sort's stability
    matters), some masked out."""
    rng = np.random.RandomState(9)
    centers = rng.uniform(-5, 5, (40, 3))
    pts = (centers[rng.randint(40, size=3000)] + rng.normal(0, 0.003, (3000, 3))).astype(
        np.float32)
    mask = rng.uniform(size=3000) > 0.2 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jax.jit(jknn.knn_dist2_jax)(jnp.asarray(pts), mask=jm))
    got = knn.knn_dist2_morton(_t(pts), mask=None if mask is None else _t(mask))
    # codes and their stable sort order
    lo, hi = pts.min(0), pts.max(0)
    if mask is not None:
        lo, hi = pts[mask].min(0), pts[mask].max(0)
    p01 = (pts - lo) / np.maximum(hi - lo, 1e-9)
    jcodes = np.asarray(jknn._morton_codes(jnp.asarray(p01)))
    codes = knn._morton_codes(_t(p01))
    np.testing.assert_array_equal(codes.numpy(), jcodes.astype(np.int64))
    assert len(np.unique(jcodes)) < 2500
    np.testing.assert_array_equal(torch.sort(codes, stable=True).indices.numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(jcodes))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    if mask is not None:
        assert (got.numpy()[~mask] == 0).all() and (got.numpy()[mask] > 0).all()
    exact = knn.knn_dist2(pts[mask] if mask is not None else pts)
    approx = got.numpy()[mask] if mask is not None else got.numpy()
    assert 0.5 < np.median(approx / exact) < 2.0


# ------------------------------------------------------------------ CLIs

STUB = """#!{python}
import json, os, sys
with open(os.environ["COLMAP_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
if sys.argv[1] == "image_undistorter":
    out = sys.argv[sys.argv.index("--output_path") + 1]
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        open(os.path.join(out, "sparse", name), "w").close()
"""


@pytest.mark.parametrize("nerfosr", [False, True])
def test_convert_runs_the_same_colmap_commands(tmp_path, monkeypatch, nerfosr):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "colmap"
    stub.write_text(STUB.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bin_dir))   # no colmap elsewhere
    calls = {}
    for name, mod in (("jax", jconvert), ("port", convert)):
        scene = tmp_path / name / "scene"
        (scene / "input").mkdir(parents=True)
        log = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("COLMAP_LOG", str(log))
        mod.main([f"--source_path={scene}", "--no_gpu"] + (["--nerfosr"] if nerfosr else []))
        calls[name] = [[a.replace(str(scene), "<scene>") for a in json.loads(line)]
                       for line in log.read_text().splitlines()]
        assert sorted(os.listdir(scene / "sparse" / "0")) == ["cameras.bin", "images.bin",
                                                            "points3D.bin"]
    assert calls["port"] == calls["jax"]
    assert [c[0] for c in calls["port"]] == ["feature_extractor", "exhaustive_matcher",
                                             "mapper", "image_undistorter"]
    assert ("--SiftMatching.guided_matching" in calls["port"][1]) == nerfosr
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for mod in (jconvert, convert):
        with pytest.raises(SystemExit, match="colmap CLI not found"):
            mod.convert(str(tmp_path / "jax" / "scene"))


def test_tune_random_search_matches_jax(tmp_path, monkeypatch):
    """The fallback search (no Optuna here) with a stand-in objective writes
    the JAX package's trials.jsonl; then one real objective, 2 iterations on
    the CPU."""
    assert tune.SEARCH_SPACE == jtune.SEARCH_SPACE
    score = lambda scenes, params, iterations, out, *dev: float(
        np.log(params["optimizer.lambda_envlight"]) - params["model.embeddings_dim"] / 32)
    out = {}
    for name, mod in (("jax", jtune), ("port", tune)):
        monkeypatch.setattr(mod, "objective", score)
        mod.main(["--scenes=a,b", "--trials=4", "--iterations=3",
                  f"--output={tmp_path / name}"] + (["--device=cpu"] if name == "port" else []))
        out[name] = (tmp_path / name / "trials.jsonl").read_text()
    assert out["port"] == out["jax"] and len(out["port"].splitlines()) == 4
    monkeypatch.undo()

    data = str(tmp_path / "scene")
    make_dataset(data)
    psnr = tune.objective([data], {"model.embeddings_dim": 16, "runtime.pool_capacity": 4096,
                                   "runtime.max_dup": 16384}, 2, str(tmp_path / "real"),
                          device="cpu")
    assert np.isfinite(psnr) and psnr > 0
