"""Share of the card's float32 peak that one training step's needed
operations take in the step's time (the traced steps' wall time per step):
the compositor forward and backward on the captured steps' pairs, preprocess,
shading and Adam per live Gaussian, the loss stack per pixel
(`roofline.train_step_ops`)."""

from benchmark import roofline


def read(ctx):
    pairs = ctx.composite_pairs("composite_backward")
    if not pairs:
        return None
    C = ctx.captures["composite_backward"][0][0].shape[1] - 6
    ops = sum(roofline.train_step_ops(p, C, ctx.info["live"], ctx.info["pixels"])
              for p in pairs) / len(pairs)
    return 100.0 * ops / (ctx.info["step_s"] * roofline.FP32_OPS_PER_S)
