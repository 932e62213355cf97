"""Share of the card's float32 peak that one served frame's needed operations
take in the frame's time (the traced frames' wall time per frame): the MLP,
preprocess and shading per live Gaussian, the compositor forward on the
captured frames' pairs (`roofline.frame_ops`)."""

from benchmark import roofline


def read(ctx):
    pairs = ctx.composite_pairs("composite_forward")
    if not pairs:
        return None
    ops = sum(roofline.frame_ops(p, ctx.info["live"], ctx.info["mlp_params"])
              for p in pairs) / len(pairs)
    return 100.0 * ops / (ctx.info["step_s"] * roofline.FP32_OPS_PER_S)
