"""The ViTDet cell's benchmark files: the frozen counts against sums by hand;
the level-wise walk; and `serve_levels.run` on the CPU at a small size with
the cell's own limits: the sound program is correct, the fp8 control and
the faults (a) NMS across levels, (b) one global top-k, (c) no relative
positions and ``num_valid`` truncated are not. The
small model draws its relative positions wider (std 2) than the cell's
0.15, so that at 8 x 8 tokens and four blocks of 64 channels dropping them
moves its outputs as far as it moves the published model's (gap_p50 about
twice the sound run's in both)."""

import copy
import importlib.util
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import counts_levels, harness, readings_levels
from portbench import run as pb_run
from portbench.drivers import serve_levels

CELL = "serve-vitdet-b16"
SEED = 2 ** 31 + 977
SMALL = {"img_size": 128, "embed_dim": 64, "depth": 4, "num_heads": 2, "window_size": 3,
         "global_blocks": [1, 3], "pyramid_channels": 32, "pre_nms_topk": 50,
         "post_nms_topk": 100}


def test_forward_flops_by_hand():
    cfg = harness.config("vitdet_b-1024-serve")
    T, C, H = 4096, 768, 3072
    patch = 2 * T * 768 * C
    glob = 2 * T * C * 3 * C + 2 * T * C * C + 12 * (4 * T * T * 64 + 4 * T * 64 * 64) + 4 * T * C * H
    W = 4900  # 70 x 70 padded tokens, 25 windows of 196
    win = (2 * W * C * 3 * C + 2 * W * C * C + 25 * 12 * (4 * 196 * 196 * 64 + 4 * 196 * 14 * 64)
           + 4 * T * C * H)
    up = 2 * 64 * 64 * C * 384 * 4 + 2 * 128 * 128 * 384 * 192 * 4 + 2 * 64 * 64 * C * 384 * 4
    lat = sum(2 * s * s * (ci * 256 + 256 * 256 * 9)
              for s, ci in ((256, 192), (128, 384), (64, 768), (32, 768)))
    head = (256 ** 2 + 128 ** 2 + 64 ** 2 + 32 ** 2 + 16 ** 2) * (2 * 2 * 256 * 256 * 9 + 2 * 256 * 15)
    assert counts_levels.forward_flops(cfg) == patch + 4 * glob + 8 * win + up + lat + head
    assert round(counts_levels.forward_flops(cfg) / 1e12, 3) == 1.316
    ms, by = counts_levels.global_attn_bound(16, cfg)
    assert by == "operations" and ms == pytest.approx(
        4 * 16 * 12 * (4 * T * T * 64 + 4 * T * 64 * 64) / 989e12 * 1e3)


def test_level_walk_counts():
    keep = [True, True, False, True, True, False, True]
    lev = [0, 1, 0, 0, 1, 1, 0]
    # tests: each box against the keeps of its level before it
    assert counts_levels.level_walk_counts(keep, lev, 10) == (0 + 0 + 1 + 1 + 1 + 2 + 2, 7)
    assert counts_levels.level_walk_counts(keep, lev, 3) == (0 + 0 + 1 + 1, 4)


def small(rel_pos=2.0):
    wl = copy.deepcopy(harness.workload(CELL))
    cfg = copy.deepcopy(harness.config(wl["config"]))
    cfg.update(SMALL)
    cfg["init"]["rel_pos"] = rel_pos
    wl["traffic"].update(batch=4, pool=8, raw_h=96, raw_w=128)
    wl["warmup"] = 1
    wl["check"].update(sample_images=8, block=4)
    return wl, cfg


@pytest.mark.parametrize("kind", ["sound", "control", "across", "global_topk", "no_rel_pos",
                                  "truncated"])
def test_the_cell_judges_the_faults(kind):
    torch.set_num_threads(8)
    wl, cfg = small()
    hooks = None if kind == "sound" else readings_levels.hooks(torch, kind, cfg, "cpu")
    rec = serve_levels.run(torch, wl, cfg, SEED, 0.3, False, "cpu", harness.Spans(), hooks)
    rec["setup_s"] = 1.0
    result, _ = pb_run.result_line(harness.benchmark(), CELL, wl, rec, False, 1, "cpu")
    assert set(result["metrics"]) >= {"setup_s", "serve_img_per_s", "serve_batch_p95_ms"}
    assert result["correct"] == (kind == "sound"), result["checks"]


def test_traced_run_on_the_cpu_reports_no_device_metric():
    wl, cfg = small()
    wl["traffic"].update(batch=2, pool=4)
    wl.update(trace={"warmup": 1, "iters": 2})
    wl["check"].update(sample_images=2, block=2)
    rec = serve_levels.run(torch, wl, cfg, SEED, 0.2, True, "cpu", harness.Spans())
    rec["setup_s"] = 1.0
    result, _ = pb_run.result_line(harness.benchmark(), CELL, wl, rec, True, 1, "cpu")
    assert result["correct"]
    # no device: the program stretch has spans but no operations, every reader None
    st = rec["program"]
    assert st["ops"] is None and not st["complete"]
    names = {s[0] for s in st["spans"]}
    assert names == {"rpn.predict", "rpn.upload", "rpn.stem", "rpn.backbone", "rpn.attn.window",
                     "rpn.attn.global", "rpn.pyramid", "rpn.head", "rpn.decode", "rpn.select"}
    assert not any(m.startswith("vitdet.") for m in result["metrics"])
    assert rec["bounds_ms"]["global_attn"] > 0 and rec["bounds_ms"]["proposal"] > 0


def test_readers_on_a_stretch():
    spans = [("rpn.predict", None, 0, 1000), ("rpn.backbone", 0, 100, 600),
             ("rpn.attn.window", 1, 150, 200), ("rpn.attn.global", 1, 300, 400),
             ("rpn.pyramid", 0, 600, 700), ("rpn.select", 0, 800, 900)]
    ops = [("gemm", 120, 140, 110, 1), ("fmha_w", 160, 190, 160, 1), ("fmha_g", 310, 390, 310, 1),
           ("conv", 610, 650, 605, 1), ("proposal_kernel_levels", 820, 870, 810, 1)]
    from portbench import program

    st = {"iters": 1, "window_ns": (0, 1000), "spans": spans, "ops": ops}
    st.update(program.self_check(st, {"proposal_kernel": 1}))
    rec = {"program": st, "bounds_ms": {"global_attn": 40e-6}}

    def read(name):
        spec = importlib.util.spec_from_file_location(name, harness.ROOT / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read(rec)

    assert read("vitdet.backbone_ms") == pytest.approx(130e-6)
    assert read("vitdet.window_attn_ms") == pytest.approx(30e-6)
    assert read("vitdet.global_attn_ms") == pytest.approx(80e-6)
    assert read("vitdet.global_attn.roofline_pct") == pytest.approx(50.0)
    assert read("vitdet.pyramid_ms") == pytest.approx(40e-6)
    assert read("serve.select_ms") == pytest.approx(50e-6)
    rec["program"] = {**st, "complete": False}
    assert read("vitdet.backbone_ms") is None and read("vitdet.global_attn.roofline_pct") is None


def test_new_modules_load_nothing_forbidden():
    probe = ("import sys; sys.path.insert(0, %r); import portbench.drivers.serve_levels, "
             "portbench.readings_levels, portbench.check_levels, portbench.counts_levels, "
             "portbench.reference.vitdet; from portbench import harness; "
             "print(','.join(harness.forbidden_modules()))" % str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, timeout=300)
    assert out.stdout.strip() == ""
    ref = ("import sys; sys.path.insert(0, %r); import portbench.reference.vitdet; "
           "print(sorted({m.split('.')[0] for m in sys.modules} & "
           "{'tpurpn_torch', 'tpurpn', 'jax'}))" % str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", ref], capture_output=True, text=True, check=True,
                         timeout=300)
    assert out.stdout.strip() == "[]"


def test_config_holds_the_published_settings():
    cfg = harness.config("vitdet_b-1024-serve")
    assert (cfg["embed_dim"], cfg["depth"], cfg["num_heads"], cfg["window_size"]) == (768, 12, 12, 14)
    assert cfg["global_blocks"] == [2, 5, 8, 11] and cfg["reduced"] == []
    assert sum(s * s for s in counts_levels.level_shapes(cfg)) * 3 == cfg["anchors"] == 261888
    assert np.isclose(cfg["scale_clamp"], np.log(1000 / 16))
