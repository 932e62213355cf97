"""The preprocess as one differentiable operation (`ops/preprocess.py`
`preprocess`) on the CPU: its analytic backward (`preprocess_backward_plain`,
the derivation kernel R' runs) against autograd over the plain chain, and its
CPU route against the plain chain, bit for bit and with no kernel launch.
The card's kernels are held to the same in tests/test_torch_cuda.py.
"""

import pytest
import torch

from relightable3dgaussians_w_torch.ops import preprocess as P
from relightable3dgaussians_w_torch.ops.cuda import preprocess as preprocess_kernel

from _preprocess_rows import SIZE, cotangents, edge_camera, random_rows
import _torch_threads

_torch_threads.share_cores()

# case -> (dtype, scale_modifier, skip_alpha, precomputed covariance, opacities, active)
CASES = {
    "tightened": (torch.float64, 1.0, 1.0 / 255.0, False, True, True),
    "untightened": (torch.float64, 1.0, 1.0 / 255.0, False, False, False),
    "precomp": (torch.float64, 1.0, 1.0 / 255.0, True, True, True),
    "modifier_lod": (torch.float64, 1.3, 1.0 / 32.0, False, True, True),
    "float32": (torch.float32, 1.0, 1.0 / 255.0, False, True, True),
}


def _inputs(case, n=300, seed=0):
    dtype, mod, skip, precomp, with_op, with_active = CASES[case]
    means, scales, quats, opac, active, cov = (
        t.to(dtype) if t.is_floating_point() else t for t in random_rows(n, seed))
    cam = edge_camera()
    kw = dict(scale_modifier=mod, skip_alpha=skip, opacities=opac if with_op else None,
              active=active if with_active else None)
    return means, scales, quats, (cov if precomp else None), cam, kw


def _plain_autograd(means, scales, quats, cov, cam, kw, cot):
    leaves = [t.clone().requires_grad_(True) for t in
              ((means, cov) if cov is not None else (means, scales, quats))]
    args = ((leaves[0], None, None) if cov is not None else tuple(leaves))
    pre = P.preprocess_plain(*args, cam.viewmat, cam.projmat, cam.tan_fovx, cam.tan_fovy, SIZE,
                             SIZE, 16, cov3d_precomp=leaves[1] if cov is not None else None, **kw)
    loss = sum((getattr(pre, f) * c).sum() for f, c in
               zip(("mean2d", "conic", "depth", "cov3d"), cot))
    return pre, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("case", list(CASES))
def test_preprocess_backward_plain_matches_autograd(case):
    """The analytic gradient against autograd over the plain chain, every leaf
    within 1e-9 of its largest value in float64 (2e-5 in float32), at the
    edge rows (near plane, frustum clamp and its tie, culled and padded rows,
    a singular screen covariance) and 287 random ones."""
    means, scales, quats, cov, cam, kw = _inputs(case)
    with torch.no_grad():
        pre = P.preprocess_plain(means, scales, quats, cam.viewmat, cam.projmat, cam.tan_fovx,
                                 cam.tan_fovy, SIZE, SIZE, 16, cov3d_precomp=cov, **kw)
    cot, idle = cotangents(pre, seed=1)
    cot = [c.to(means.dtype) for c in cot]
    _, want = _plain_autograd(means, scales, quats, cov, cam, kw, cot)
    got = P.preprocess_backward_plain(means, scales, quats, cam.viewmat, cam.projmat,
                                      cam.tan_fovx, cam.tan_fovy, SIZE, SIZE,
                                      kw["scale_modifier"], cov, *cot)
    got = [g for g in got if g is not None]
    tol = 1e-9 if means.dtype == torch.float64 else 2e-5
    for g, w in zip(got, want, strict=True):
        assert float((g - w).abs().max()) <= tol * float(w.abs().max()), case
        assert not g[idle].any()   # rows with all-zero cotangents: exactly 0
    assert int(pre.tiles_touched.sum()) > 0 and bool(idle.any()) and not bool(idle.all())


@pytest.mark.parametrize("case", ["tightened", "precomp"])
def test_preprocess_cpu_route_is_the_plain_chain(case):
    """On the CPU `preprocess` returns the plain chain's fields bit for bit
    and its gradients are the analytic ones, with no kernel launch; it saves
    nothing for a call whose inputs need no gradient."""
    means, scales, quats, cov, cam, kw = _inputs(case, n=100)
    call = lambda fn, m, s, q, c: fn(m, s, q, cam.viewmat, cam.projmat, cam.tan_fovx,
                                     cam.tan_fovy, SIZE, SIZE, 16, cov3d_precomp=c, **kw)
    before = (preprocess_kernel.launches, preprocess_kernel.backward_launches)
    with torch.no_grad():
        want = call(P.preprocess_plain, means, scales, quats, cov)
    got = call(P.preprocess, means, scales, quats, cov)
    for f in P.PreprocessOut._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.mean2d.grad_fn is None or not got.mean2d.grad_fn.saved_tensors
    leaves = [t.clone().requires_grad_(True) for t in (means, scales, quats)]
    c = None if cov is None else cov.clone().requires_grad_(True)
    pre = call(P.preprocess, *leaves, c) if c is None else call(P.preprocess, leaves[0], None,
                                                                None, c)
    cot, _ = cotangents(pre, seed=2)
    torch.autograd.backward([pre.mean2d, pre.conic, pre.depth, pre.cov3d],
                            [x.to(means.dtype) for x in cot])
    g = P.preprocess_backward_plain(means, scales, quats, cam.viewmat, cam.projmat,
                                    cam.tan_fovx, cam.tan_fovy, SIZE, SIZE,
                                    kw["scale_modifier"], cov, *[x.to(means.dtype) for x in cot])
    assert torch.equal(leaves[0].grad, g[0])
    if c is None:
        assert torch.equal(leaves[1].grad, g[1]) and torch.equal(leaves[2].grad, g[2])
    else:
        assert torch.equal(c.grad, g[3])
    assert (preprocess_kernel.launches, preprocess_kernel.backward_launches) == before
