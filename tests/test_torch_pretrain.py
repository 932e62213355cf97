"""The torch port's pretraining slice against the JAX package, on the CPU.

The same numpy inputs and weights through both packages: the embedding
autoencoder's forward (reconstruction and latent, batch statistics on and off,
1e-5 of the largest output), its loss gradients (5e-3 per parameter), its
running statistics after a training call (1e-6), `pretrain_embedding_net` for
2 epochs with a trailing partial batch and JAX's own noise (per-step losses
1e-4 relative; final weights' updates 5e-3; running statistics 5e-3),
`encode_embeddings` (1e-4), `initialize_sh_mlp` with JAX's own dropout masks
(updates 5e-3) and its prior matching, and the train CLI with both init flags
on a tiny NeRF-OSR-layout scene. The small autoencoder has channels_f 8.

A convolution bias in front of a batch-statistics BatchNorm has no effect on
the loss (the norm subtracts the per-channel batch mean), so its gradient is
zero up to rounding and Adam turns that rounding into steps of either sign.
Those eight biases are held to that: gradients at rounding level, and moves
within Adam's step bound.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relightable3dgaussians_w_tpu import pretrain as jpretrain
from relightable3dgaussians_w_tpu.models.nets import EmbeddingNet as JEmbeddingNet
from relightable3dgaussians_w_tpu.models.nets import MLPNet as JMLPNet
from relightable3dgaussians_w_tpu.models.nets import init_embedding_net, init_mlp

from relightable3dgaussians_w_torch import convert, pretrain, trainer
from relightable3dgaussians_w_torch.cli import train as cli_train
from relightable3dgaussians_w_torch.models.nets import EmbeddingNet, MLPNet

from test_nerfosr_e2e import make_nerfosr_dataset

S, CF, LATENT = 16, 8, 4
N_IMAGES, BATCH, EPOCHS = 6, 4, 2
AE_STEPS = EPOCHS * -(-N_IMAGES // BATCH)
CONV_BIASES = [f"{m}.{i}.bias" for m in ("conv", "deconv") for i in range(4)]
# Lighting conditions of both name forms (C-prefixed and `<condition>_DSC_0000`).
NAMES = ["C01_IMG_0004", "lk2-2019-12-01_DSC_0005", "C03_IMG_0002", "lk2-2019-12-01_DSC_0007"]
PRIOR_FILES = ["C01.npy", "C03.npy", "lk2-2019-12-01.npy", "st-2020-01-02.npy"]

JNet8 = functools.partial(JEmbeddingNet, channels_f=CF)
Net8 = functools.partial(EmbeddingNet, channels_f=CF)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


class _MeanRecorder:
    """Stands in for numpy in the JAX pretrain module: records the per-step
    losses that each epoch's log line averages."""

    def __init__(self):
        self.inputs = []

    def __getattr__(self, name):
        return getattr(np, name)

    def mean(self, a, *args, **kwargs):
        self.inputs.append(list(a))
        return np.mean(a, *args, **kwargs)


def _flax_variables(seed):
    """Flax variables of the small autoencoder in flax's layout, drawn with
    numpy (no JAX compile): LeCun-scaled kernels, nonzero biases, BN scales and
    biases, running means around 0 and variances in [0.05, 0.5]."""
    shapes = jax.eval_shape(lambda k: init_embedding_net(k, JNet8(latent_dim=LATENT,
                                                                  input_shape=S)),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    draw = {"kernel": lambda s: rng.normal(0, 1 / np.sqrt(np.prod(s[:-1])), s),
            "bias": lambda s: rng.normal(0, 0.1, s), "scale": lambda s: rng.uniform(0.5, 1.5, s),
            "mean": lambda s: rng.normal(0, 0.05, s), "var": lambda s: rng.uniform(0.05, 0.5, s)}
    return jax.tree_util.tree_map_with_path(
        lambda path, a: draw[path[-1].key](a.shape).astype(np.float32), shapes)


def _port_net(variables):
    net = Net8(latent_dim=LATENT, input_shape=S)
    net.load_state_dict(convert.embedding_net_from_flax(variables))
    return net


def _jax_dropout_masks(mlp, params, key, sizes):
    """The dropout keep-masks `initialize_sh_mlp` draws at each step: the same
    key chain, read from the Dropout layer's output on a first layer that
    outputs ones."""
    probe = jax.tree.map(jnp.zeros_like, params)
    probe["Dense_0"]["bias"] = jnp.ones_like(probe["Dense_0"]["bias"])
    dropout = jax.jit(lambda k, e: mlp.apply(
        {"params": probe}, e, deterministic=False, rngs={"dropout": k},
        capture_intermediates=True, mutable=["intermediates"])[1]["intermediates"]
        ["Dropout_0"]["__call__"][0])
    masks = []
    for b in sizes:
        key, k = jax.random.split(key)
        masks.append(np.asarray(dropout(k, jnp.zeros((b, mlp.embedding_dim)))) != 0)
    return masks


@pytest.fixture(scope="module")
def ref():
    """Every JAX result the tests compare with, computed once."""
    out = {}
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, (3, S, S, 3)).astype(np.float32)
    v = _flax_variables(1)
    jn = JNet8(latent_dim=LATENT, input_shape=S)

    def loss(params, stats, train):
        recon, _ = jn.apply({"params": params, "batch_stats": stats}, x, pretraining=True,
                            train=train, mutable=["batch_stats"])
        return jnp.mean((recon - x) ** 2)

    @jax.jit
    def outputs(v):   # one compile for every forward variant and both gradients
        fwd = {(p, t): jn.apply(v, x, pretraining=p, train=t, mutable=["batch_stats"])
               for p in (False, True) for t in (False, True)}
        return fwd, {t: jax.grad(loss)(v["params"], v["batch_stats"], t) for t in (False, True)}

    out["forward"], out["grads"] = jax.device_get(outputs(v))
    out.update(x=x, variables=v)

    # pretrain_embedding_net at channels_f 8, 2 epochs of batches 4 and 2.
    images = rng.uniform(0, 1, (N_IMAGES, S, S, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    rec = _MeanRecorder()
    key, k_init = jax.random.split(key)
    init = _flax_variables(2)   # what JAX's init draws from k_init, here from numpy

    def init_embedding_net_stub(k, net):
        assert (np.asarray(k) == np.asarray(k_init)).all() and net == JNet8(
            latent_dim=LATENT, input_shape=S)
        return jax.tree.map(jnp.asarray, init)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpretrain, "np", rec)
        mp.setattr(jpretrain, "EmbeddingNet", JNet8)
        mp.setattr(jpretrain, "init_embedding_net", init_embedding_net_stub)
        _, trained = jpretrain.pretrain_embedding_net(jax.random.PRNGKey(7), images,
                                                      num_epochs=EPOCHS, batch_size=BATCH,
                                                      latent_dim=LATENT, log_every=1)
    noise = []
    for _ in range(EPOCHS):
        for i in range(0, N_IMAGES, BATCH):
            key, k = jax.random.split(key)
            noise.append(np.asarray(jax.random.normal(
                k, (min(BATCH, N_IMAGES - i), S, S, 3))))
    out["ae"] = dict(images=images, init=init, noise=noise, losses=rec.inputs,
                     trained=jax.device_get(trained))
    out["encoded"] = np.asarray(jpretrain.encode_embeddings(jn, v, images, batch=4))

    # initialize_sh_mlp: 3 epochs of two batches of 2.
    jm = JMLPNet(sh_degree_envl=2, embedding_dim=8, dense_layer_size=32)
    mlp_params = jax.device_get(jax.jit(lambda k: init_mlp(k, jm))(jax.random.PRNGKey(3)))
    emb = rng.normal(size=(len(NAMES), 8)).astype(np.float32)
    priors = {f: rng.normal(size=(25, 3)) for f in PRIOR_FILES}
    key = jax.random.PRNGKey(11)
    fitted = jpretrain.initialize_sh_mlp(key, jm, mlp_params, jnp.asarray(emb), NAMES, priors,
                                         epochs=3, batch_size=2)
    out["sh"] = dict(params=mlp_params, emb=emb, priors=priors, fitted=jax.device_get(fitted),
                     keep=_jax_dropout_masks(jm, mlp_params, key, [2, 2] * 3))
    return out


# ------------------------------------------------------------------ EmbeddingNet


@pytest.mark.parametrize("pretraining", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_embedding_net_forward_matches_flax(ref, pretraining, train):
    net = _port_net(ref["variables"])
    with torch.no_grad():
        got = net(torch.as_tensor(ref["x"]), pretraining=pretraining, train=train)
    want = ref["forward"][(pretraining, train)][0]
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("pretraining", [False, True])
def test_embedding_net_running_stats_match_flax(ref, pretraining):
    """One training call moves the running statistics as flax does: momentum
    0.9 on the old value, the biased batch variance. Without `pretraining`
    the decoder's statistics stay."""
    net = _port_net(ref["variables"])
    with torch.no_grad():
        net(torch.as_tensor(ref["x"]), pretraining=pretraining, train=True)
    want = convert.embedding_net_from_flax(
        {"params": ref["variables"]["params"],
         "batch_stats": ref["forward"][(pretraining, True)][1]["batch_stats"]})
    old = convert.embedding_net_from_flax(ref["variables"])
    sd = net.state_dict()
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(_np(sd[k]), _np(want[k]), rtol=0, atol=1e-6)
            moved = float((want[k] - old[k]).abs().max()) > 1e-3
            assert moved == (pretraining or int(k.split(".")[1]) < 4), k


@pytest.mark.parametrize("train", [False, True])
def test_embedding_net_grads_match_flax(ref, train):
    """Gradients of the pretraining loss for every parameter."""
    net = _port_net(ref["variables"])
    x = torch.as_tensor(ref["x"])
    loss = torch.mean((net(x, pretraining=True, train=train) - x) ** 2)
    loss.backward()
    want = convert.embedding_net_from_flax({"params": ref["grads"][train]})
    top = max(float(g.abs().max()) for g in want.values())
    params = dict(net.named_parameters())
    assert set(params) == set(want)
    for k, p in params.items():
        if train and k in CONV_BIASES:   # zero up to rounding (module docstring)
            assert float(p.grad.abs().max()) < 1e-5 * top
            assert float(want[k].abs().max()) < 1e-5 * top
        else:
            assert _rel(p.grad, want[k]) < 5e-3, k


# ------------------------------------------------------------------ pretraining


def test_pretrain_embedding_net_matches_jax(ref, monkeypatch):
    """2 epochs of 6 images in batches of 4 and 2, from flax's initial weights
    with JAX's noise: the per-step losses, every weight's update and the
    running statistics."""
    ae = ref["ae"]
    monkeypatch.setattr(pretrain, "EmbeddingNet", Net8)
    init = convert.embedding_net_from_flax(ae["init"])
    net, losses = pretrain.pretrain_embedding_net(
        torch.Generator().manual_seed(0), ae["images"], num_epochs=EPOCHS, batch_size=BATCH,
        latent_dim=LATENT, log_every=1, init=init, noise=ae["noise"])
    assert [len(e) for e in losses] == [2, 2] and len(ae["noise"]) == AE_STEPS
    np.testing.assert_allclose(np.array(losses), np.array(ae["losses"]), rtol=1e-4, atol=0)
    want = convert.embedding_net_from_flax(ae["trained"])
    sd = net.state_dict()
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(_np(sd[k]), _np(want[k]), rtol=0, atol=5e-3)
        elif k in CONV_BIASES:   # Adam steps on rounding: within AE_STEPS steps of lr
            bound = AE_STEPS * pretrain.AE_LR * 1.01
            assert max(float((w - init[k]).abs().max()) for w in (sd[k], want[k])) <= bound
        else:
            step = want[k] - init[k]
            assert float(step.abs().max()) > 1e-3, k
            assert _rel(sd[k] - init[k], step) < 5e-3, k


def test_encode_embeddings_matches_jax(ref):
    z = pretrain.encode_embeddings(_port_net(ref["variables"]), ref["ae"]["images"], batch=4)
    assert z.shape == (N_IMAGES, LATENT)
    np.testing.assert_allclose(_np(torch.linalg.vector_norm(z, dim=-1)), 1.0, atol=1e-6)
    np.testing.assert_allclose(_np(z), ref["encoded"], rtol=0, atol=1e-4)


def test_initialize_sh_mlp_matches_jax(ref):
    """3 epochs of 4 named images (both name forms) in batches of 2, with
    JAX's dropout masks: every parameter's update."""
    sh = ref["sh"]
    mlp = MLPNet(sh_degree_envl=2, embedding_dim=8, dense_layer_size=32)
    start = convert.mlp_state_dict_from_flax(sh["params"])
    fitted = pretrain.initialize_sh_mlp(torch.Generator().manual_seed(0), mlp, start,
                                        torch.as_tensor(sh["emb"]), NAMES, sh["priors"],
                                        epochs=3, batch_size=2, keep=sh["keep"])
    want = convert.mlp_state_dict_from_flax(sh["fitted"])
    assert all(m.shape == (2, 32) for m in sh["keep"]) and len(sh["keep"]) == 6
    for k in want:
        assert torch.equal(start[k], convert.mlp_state_dict_from_flax(sh["params"])[k])
        step = want[k] - start[k]
        if k.startswith("dense.3."):   # the sky head is not in the loss
            assert float(step.abs().max()) == 0 and torch.equal(fitted[k], start[k])
            continue
        assert float(step.abs().max()) > 1e-3, k
        assert _rel(fitted[k] - start[k], step) < 5e-3, k


def test_sh_prior_matching():
    """Priors by lighting condition (first sorted prior name containing it,
    sliced to (deg + 1)^2 rows); a name with no prior raises in both."""
    assert [pretrain.lighting_condition_of(n) for n in NAMES[:2]] == ["C01", "lk2-2019-12-01"]
    priors = {f: np.full((25, 3), i, np.float32) for i, f in enumerate(PRIOR_FILES)}
    t = pretrain.sh_prior_targets(NAMES, priors, 9)
    assert t.shape == (4, 9, 3) and list(t[:, 0, 0]) == [0, 2, 1, 2]
    mlp, jm = MLPNet(), JMLPNet()
    for fn, args in ((pretrain.initialize_sh_mlp, (torch.Generator(), mlp, {},
                                                   torch.zeros(1, 32))),
                     (jpretrain.initialize_sh_mlp, (jax.random.PRNGKey(0), jm, {},
                                                    jnp.zeros((1, 32))))):
        with pytest.raises(KeyError, match="C09"):
            fn(*args, ["C09_IMG_0001"], priors)


# ------------------------------------------------------------------ train CLI


def _nerfosr_scene(root):
    """tests/test_nerfosr_e2e.py's scene (3 train views, 64x64) with its views
    renamed to two lighting conditions, and one SH prior for each."""
    make_nerfosr_dataset(root)
    new = {f"img_{i:03d}": n for i, n in enumerate(
        ["C01_IMG_0001", "lk2-2019-12-01_DSC_0002", "C01_IMG_0003", "C01_IMG_0004"])}
    for d, suffix in (("images", ".png"), ("train/rgb", ".png"), ("test/rgb", ".png"),
                      ("masks", ".png"), ("sky_masks", "_mask.png")):
        for f in os.listdir(os.path.join(root, d)):
            stem = f[:-len(suffix)]
            os.rename(os.path.join(root, d, f), os.path.join(root, d, new[stem] + suffix))
    txt = os.path.join(root, "sparse/0/images.txt")
    with open(txt) as f:
        lines = f.read()
    for old, n in new.items():
        lines = lines.replace(old, n)
    with open(txt, "w") as f:
        f.write(lines)
    os.makedirs(os.path.join(root, "train/envmaps_init"))
    rng = np.random.RandomState(2)
    for cond in ("C01", "lk2-2019-12-01"):
        np.save(os.path.join(root, "train/envmaps_init", cond + ".npy"),
                rng.normal(0, 0.3, (25, 3)).astype(np.float32))


def test_train_cli_runs_pretraining(tmp_path, monkeypatch):
    """`cli.train.main` with model.init_embeddings / init_sh_mlp on the CPU:
    the autoencoder's unit-norm codes and the fitted MLP become the trainer's
    parameters before its first step; Adam's state stays as built."""
    data = str(tmp_path / "scene")
    _nerfosr_scene(data)
    seen = {}

    def record(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] = (args, fn(*args, **kwargs))
            return seen[name][1]
        monkeypatch.setattr(pretrain, name, wrapped)

    record("initialize_embeddings_from_dataset", pretrain.initialize_embeddings_from_dataset)
    record("initialize_sh_mlp", pretrain.initialize_sh_mlp)
    train = trainer.Relightable3DGWTrainer.train

    def first_state(self, *args, **kwargs):
        seen["start"] = self.state
        return train(self, *args, **kwargs)

    monkeypatch.setattr(trainer.Relightable3DGWTrainer, "train", first_state)
    monkeypatch.setattr(pretrain, "EmbeddingNet", Net8)   # 256x256 inputs, channels_f 8
    tr = cli_train.main([f"dataset.source_path={data}", f"dataset.model_path={tmp_path / 'out'}",
                         "model.init_embeddings=true", "model.init_sh_mlp=true",
                         "optimizer.embednet_pretrain_epochs=1", "optimizer.iterations=2",
                         "runtime.pool_capacity=4096", "runtime.max_dup=16384", "--device=cpu"])
    emb, (net, losses) = seen["initialize_embeddings_from_dataset"][1]
    (_, _, mlp_before, emb_in, names, priors), fitted = seen["initialize_sh_mlp"]
    start = seen["start"]
    assert emb.shape == (3, 32) and len(losses) == 1 and np.isfinite(losses[0]).all()
    assert float((torch.linalg.vector_norm(emb, dim=-1) - 1).abs().max()) < 1e-5
    assert torch.equal(start.params["embeddings"], emb) and torch.equal(emb_in, emb)
    assert names == ["C01_IMG_0001", "C01_IMG_0003", "lk2-2019-12-01_DSC_0002"]
    assert sorted(priors) == ["C01.npy", "lk2-2019-12-01.npy"]
    for k, v in fitted.items():
        assert torch.equal(start.params["mlp"][k], v)
        moved = float((v - mlp_before[k]).abs().max())
        assert moved == 0 if k.startswith("dense.3.") else moved > 1e-4, k   # sky head: no loss
    assert int(start.step) == 0 and int(start.opt_state.count) == 0
    assert all(float(m.abs().max()) == 0 for m in start.opt_state.mu["mlp"].values())
    assert int(tr.state.step) == 2
    assert all(torch.isfinite(v).all() for v in tr.state.params["mlp"].values())
