"""The reference against the port's plain path at tiny sizes on the CPU (the
test may import both; the reference imports nothing of the port), and whole
runs of the drivers with the harness's look for a card skipped."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common, scene
from benchmark.drivers import compare, serve, train
from benchmark.reference import lut as LUT
from benchmark.reference import render as RR
from benchmark.tests._cells import checkout_with_tiny_cell, tiny_serve, tiny_train


def test_fg_table_matches_the_ports():
    from relightable3dgaussians_w_torch.models.brdf_lut import get_fg_lut

    mine = LUT.fg_lut(device="cpu").numpy()
    assert np.abs(mine - get_fg_lut()).max() < 1e-6


def test_served_frame_matches_the_ports_plain_path():
    from relightable3dgaussians_w_torch import viewer

    cell = tiny_serve()
    sc, model, tr = cell["config_data"]["scene"], cell["config_data"]["model"], cell["traffic_data"]
    dev = torch.device("cpu")
    splats = scene.served_scene(sc, 5, dev)
    weights = scene.mlp_weights(model, 6, dev)
    emb = scene.embeddings(16, model["embeddings_dim"], 7, dev)
    host, _ = serve.port_host(splats, weights, emb, cell["config_data"], tr, dev)
    lut = LUT.fg_lut(device=dev)
    for r in serve.requests_of(tr, sc, 11)[:3]:
        cam = RR.camera(np.asarray(r["viewmat"], np.float32), r["fovx"], r["fovy"], host.W,
                        host.H, dev)
        with torch.inference_mode():
            envl, sky = host.mlp(emb[r["embedding_index"]][None])
            got = viewer._frame_u8(host.state, envl[0], sky, cam[:5], host.bg_color,
                                   viewer.serve_rcfg(host, host.W, host.H), 4, 1, True, False,
                                   dev)[0].numpy()
        want = RR.render_rgb_u8(splats, weights, emb[r["embedding_index"]], cam, lut).numpy()
        gaps = compare.frame_gaps(got, want)
        assert gaps["bytes_differ_share"] < 1e-3 and gaps["max_byte_gap"] <= 1


def test_training_run_is_correct_on_the_cpu():
    res, checks = train.run(tiny_train(), 2 ** 33 + 1, 1.0, False, time.perf_counter(),
                            device="cpu")
    assert res["correct"], checks
    assert res["attempted"] >= 1 and res["metrics"]["train_images_per_s"] > 0


def test_serving_run_is_correct_on_the_cpu():
    res, checks = serve.run(tiny_serve(), 2 ** 31 + 3, 2.0, False, time.perf_counter(),
                            device="cpu")
    assert res["correct"], checks
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_a_cell_added_by_files_alone_runs(tmp_path):
    cell = common.load_cell("serve-tiny", root=checkout_with_tiny_cell(tmp_path))
    res, checks = serve.run(cell, 99, 1.0, False, time.perf_counter(), device="cpu")
    assert res["correct"], checks
    assert set(res["metrics"]) == {"frames_per_s", "frame_ms_p95"}
