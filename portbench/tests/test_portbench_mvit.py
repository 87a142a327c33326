"""MViTv2-B's cell's benchmark files: the frozen counts against an
independent sum over the published block table; ``serve_mvit.run`` on the
CPU at a small size with the cell's own limits: the sound program is
correct, the fp8 control and the faults (a) no relative positions, (b) no
residual pooling and (c) ``num_valid`` cut to a sixth are not; the traced
run's spans and the new readers; the configuration's published settings.

The small model: 11 blocks of heads 16 wide (stages ending at blocks 1, 4,
7, 10), query windows of 16, a 96 x 160 canvas from 60 x 96 frames, the
published file's stds."""

import copy
import importlib.util
import subprocess
import sys

import pytest
import torch

from portbench import counts_mvit, harness, readings_mvit
from portbench import run as pb_run
from portbench.drivers import serve_mvit
from portbench.reference import mvit

CELL = "serve-mvitv2-b16"
SEED = 2 ** 31 + 977
SMALL = {"embed_dim": 16, "depth": 11, "last_block_indexes": [1, 4, 7, 10],
         "adaptive_window_size": 16, "pretrain_img_size": 64, "fpn_channels": 16,
         "min_size_test": 96, "max_size_test": 160, "pre_nms_topk": 50, "post_nms_topk": 100}

# MViTv2-B at 800 x 1088, block by block: (c_in, c_out, heads, input grid,
# query grid, key grid, q / kv window or None for a global block)
TABLE = ([(96, 96, 1, (200, 272), (200, 272), (50, 68), (56, 14))] * 2
         + [(96, 192, 2, (200, 272), (100, 136), (100, 136), (28, 28)),
            (192, 192, 2, (100, 136), (100, 136), (50, 68), (28, 14)),
            (192, 192, 2, (100, 136), (100, 136), (25, 34), None),
            (192, 384, 4, (100, 136), (50, 68), (100, 136), (14, 28))]
         + [(384, 384, 4, (50, 68), (50, 68), (50, 68), (14, 14))] * 14
         + [(384, 384, 4, (50, 68), (50, 68), (25, 34), None),
            (384, 768, 8, (50, 68), (25, 34), (50, 68), (7, 14)),
            (768, 768, 8, (25, 34), (25, 34), (25, 34), (7, 7)),
            (768, 768, 8, (25, 34), (25, 34), (25, 34), None)])


def by_hand():
    """(forward FLOPs an image, the cores' FLOPs) summed over TABLE."""
    area = lambda hw: hw[0] * hw[1]  # noqa: E731
    total, cores = 2 * 200 * 272 * 3 * 49 * 96, 0
    for ci, co, h, g, q, kv, win in TABLE:
        G, Q, K, d = area(g), area(q), area(kv), 96
        if win:  # 4 x 5 windows of the padded grids
            tq, tk = win[0] ** 2, win[1] ** 2
            core = 20 * h * (4 * tq * tk * d + 2 * tq * 2 * win[1] * d)
        else:
            core = h * (4 * Q * K * d + 2 * Q * (kv[0] + kv[1]) * d)
        cores += core
        total += 2 * G * ci * 3 * co + 18 * co * (Q + 2 * K) + core + 2 * Q * co * co
        total += 2 * G * ci * co if ci != co else 0
        total += 16 * Q * co * co
    fpn = sum(2 * s * (c * 256 + 256 * 256 * 9)
              for s, c in ((54400, 96), (13600, 192), (3400, 384), (850, 768)))
    head = (54400 + 13600 + 3400 + 850 + 221) * (2 * 256 * 256 * 9 + 2 * 256 * 15)
    return total + fpn + head, cores


def test_forward_flops_by_hand():
    cfg = harness.config("mvitv2_b-800-serve")
    hw = mvit.canvas(480, 640, cfg)[1]
    assert hw == (800, 1088)
    flops, cores = by_hand()
    assert counts_mvit.forward_flops(cfg, hw) == flops
    assert round(flops / 1e9) == 545 and round(cores / 1e9, 1) == 61.9
    # the cores' bound at B = 16: q, k, v read and the output written once
    # (bf16) and the gathered tables read once outweigh the products
    nbytes = 0
    for _, co, _, _, q, kv, win in TABLE:
        nbytes += 16 * (2 * q[0] * q[1] + 2 * kv[0] * kv[1]) * co * 2
        a, b = ((win[0], win[0]), (win[1], win[1])) if win else (q, kv)
        nbytes += (a[0] * b[0] + a[1] * b[1]) * 96 * 2
    ms, by = counts_mvit.attn_bound(16, cfg, hw)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert ms > 16 * cores / 989e12 * 1e3
    assert mvit.level_shapes(cfg, hw) == [(200, 272), (100, 136), (50, 68), (25, 34),
                                                 (13, 17)]


def small():
    wl = copy.deepcopy(harness.workload(CELL))
    cfg = copy.deepcopy(harness.config(wl["config"]))
    cfg.update(SMALL)
    wl["traffic"].update(batch=4, pool=8, raw_h=60, raw_w=96)
    wl["warmup"] = 1
    wl["check"].update(sample_images=8, block=4)
    return wl, cfg


@pytest.mark.parametrize("kind", ["sound", "control", "no_rel_pos", "no_residual_pooling",
                                  "truncated"])
def test_the_cell_judges_the_faults(kind):
    torch.set_num_threads(8)
    wl, cfg = small()
    hooks = None if kind == "sound" else readings_mvit.hooks(torch, kind, cfg, "cpu")
    rec = serve_mvit.run(torch, wl, cfg, SEED, 0.3, False, "cpu", harness.Spans(), hooks)
    rec["setup_s"] = 1.0
    result, _ = pb_run.result_line(harness.benchmark(), CELL, wl, rec, False, 1, "cpu")
    assert set(result["metrics"]) >= {"setup_s", "serve_img_per_s", "serve_batch_p95_ms"}
    assert result["correct"] == (kind == "sound"), result["checks"]


def test_traced_run_on_the_cpu_reports_no_device_metric():
    wl, cfg = small()
    wl["traffic"].update(batch=2, pool=4)
    wl.update(trace={"warmup": 1, "iters": 2})
    wl["check"].update(sample_images=2, block=2)
    rec = serve_mvit.run(torch, wl, cfg, SEED, 0.2, True, "cpu", harness.Spans())
    rec["setup_s"] = 1.0
    result, _ = pb_run.result_line(harness.benchmark(), CELL, wl, rec, True, 1, "cpu")
    assert result["correct"]
    st = rec["program"]
    assert st["ops"] is None and not st["complete"]
    names = {s[0] for s in st["spans"]}
    assert names == {"rpn.predict", "rpn.upload", "rpn.stem", "rpn.backbone", "rpn.attn.pool",
                     "rpn.attn.window", "rpn.attn.global", "rpn.pyramid", "rpn.head",
                     "rpn.decode", "rpn.select"}
    assert not any(m.startswith("mvit.") for m in result["metrics"])
    assert rec["bounds_ms"]["mvit_attn"] > 0 and rec["bounds_ms"]["proposal"] > 0


def test_readers_on_a_stretch():
    spans = [("rpn.predict", None, 0, 1000), ("rpn.backbone", 0, 100, 600),
             ("rpn.attn.pool", 1, 110, 140), ("rpn.attn.window", 1, 150, 200),
             ("rpn.attn.pool", 1, 280, 300), ("rpn.attn.global", 1, 300, 400),
             ("rpn.pyramid", 0, 600, 700), ("rpn.select", 0, 800, 900)]
    ops = [("gemm", 105, 125, 102, 1), ("conv_dw", 120, 130, 112, 1),
           ("fmha_w", 160, 190, 160, 1), ("conv_dw", 290, 300, 285, 1),
           ("fmha_g", 310, 390, 310, 1), ("conv", 610, 650, 605, 1),
           ("proposal_kernel_levels", 820, 870, 810, 1)]
    from portbench import program

    st = {"iters": 1, "window_ns": (0, 1000), "spans": spans, "ops": ops}
    st.update(program.self_check(st, {"proposal_kernel": 1}))
    rec = {"program": st, "bounds_ms": {"mvit_attn": 55e-6}}

    def read(name):
        spec = importlib.util.spec_from_file_location(name, harness.ROOT / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read(rec)

    assert read("mvit.backbone_ms") == pytest.approx(150e-6)
    assert read("mvit.pool_ms") == pytest.approx(20e-6)
    assert read("mvit.attn_ms") == pytest.approx(110e-6)
    assert read("mvit.attn.roofline_pct") == pytest.approx(50.0)
    assert read("mvit.fpn_ms") == pytest.approx(40e-6)
    rec["program"] = {**st, "complete": False}
    assert all(read(n) is None for n in ("mvit.backbone_ms", "mvit.pool_ms", "mvit.attn_ms",
                                         "mvit.attn.roofline_pct", "mvit.fpn_ms"))
    rec["program"] = st
    del rec["bounds_ms"]  # a record without the bound (another cell's): no share
    assert read("mvit.attn.roofline_pct") is None


def test_new_modules_load_nothing_forbidden():
    probe = ("import sys; sys.path.insert(0, %r); import portbench.drivers.serve_mvit, "
             "portbench.readings_mvit, portbench.counts_mvit, portbench.reference.mvit; "
             "from portbench import harness; print(','.join(harness.forbidden_modules()))"
             % str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, timeout=300)
    assert out.stdout.strip() == ""
    ref = ("import sys; sys.path.insert(0, %r); import portbench.reference.mvit, "
           "portbench.counts_mvit; print(sorted({m.split('.')[0] for m in sys.modules} & "
           "{'tpurpn_torch', 'tpurpn', 'jax'}))" % str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", ref], capture_output=True, text=True, check=True,
                         timeout=300)
    assert out.stdout.strip() == "[]"


def test_config_holds_the_published_settings():
    cfg = harness.config("mvitv2_b-800-serve")
    assert (cfg["embed_dim"], cfg["depth"], cfg["num_heads"]) == (96, 24, 1)
    assert cfg["last_block_indexes"] == [1, 4, 20, 23] and cfg["reduced"] == []
    assert (cfg["adaptive_kv_stride"], cfg["adaptive_window_size"], cfg["residual_pooling"]) == (
        4, 56, True)
    assert (cfg["min_size_test"], cfg["max_size_test"], cfg["size_divisibility"]) == (800, 1333, 32)
    assert (cfg["fpn_channels"], cfg["head_convs"]) == (256, 1)
    hw = mvit.canvas(480, 640, cfg)[1]
    assert sum(h * w for h, w in mvit.level_shapes(cfg, hw)) * 3 == cfg["anchors"] == 217413
    shapes = mvit.param_shapes(cfg)
    backbone = sum(torch.Size(s).numel() for k, s in shapes.items() if k.startswith("backbone."))
    assert 50e6 < backbone < 52e6  # about 51 M parameters: one card holds it whole
