"""Swin-B's cell's benchmark files: the frozen counts against a direct sum
over the published stages and one block counted by hand;
``serve_swin.run`` on the CPU at a small size with the cell's own limits:
the sound program is correct, the fp8 control and the faults (a) no
cyclic shift, (b) rolled but unmasked, (c) no relative-position bias and
(d) ``num_valid`` cut to a sixth are not; the traced run's spans and the
new readers; the configuration's published settings.

The small model: widths 32-256 (heads 1, 2, 4, 8 of 32), two blocks a
stage, window 7, a 96 x 160 canvas from 60 x 96 frames (stage grids 24 x
40 to 3 x 5, each padded to whole windows), the published file's stds but
for the backbone's linear weights at 0.05 in place of 0.02: at a thirty-
second of the published widths, 0.02 leaves the attention too little of
the residual stream for a fault in it to show (gap_p50 under the limit
with the bias dropped), where 0.05 puts each fault at 1.7-2.3 times it and
the sound program at a sixth of it."""

import copy
import importlib.util
import subprocess
import sys

import pytest
import torch

from portbench import counts_swin, harness, readings_swin
from portbench import run as pb_run
from portbench.drivers import serve_swin
from portbench.reference import swin

CELL = "serve-swin-b16"
SEED = 2 ** 31 + 2503
SMALL = {"embed_dim": 32, "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8], "fpn_channels": 16,
         "min_size_test": 96, "max_size_test": 160, "pre_nms_topk": 50, "post_nms_topk": 100}


def test_forward_flops_by_hand():
    """Swin-B at 800 x 1088: the stages' grids, each padded to windows of 7,
    summed by hand; one block of stage 3 counted term by term."""
    cfg = harness.config("swin_b-800-serve")
    hw = swin.canvas(480, 640, cfg)[1]
    assert hw == (800, 1088)
    grids = [((200, 272), (203, 273)), ((100, 136), (105, 140)), ((50, 68), (56, 70)),
             ((25, 34), (28, 35))]
    st = counts_swin.stages(cfg, hw)
    assert [(s["grid"], s["padded"]) for s in st] == grids
    # the windows an image by stage: 1,131, 300, 80 and 20 of 49 tokens
    assert [p[0] * p[1] // 49 for _, p in grids] == [1131, 300, 80, 20]
    # one block of stage 3 (C 512, 16 heads of 32) on 56 x 70 padded, 50 x 68 real
    tp, t, c = 56 * 70, 50 * 68, 512
    qkv, proj, mlp = 2 * tp * c * 3 * c, 2 * tp * c * c, 2 * (2 * t * c * 4 * c)
    core = 80 * 16 * (2 * 49 * 49 * 32 + 2 * 49 * 49 * 32)
    assert counts_swin.block_flops(cfg, st[2]) == qkv + core + proj + mlp
    total, cores, nbytes = 2 * 200 * 272 * 48 * 128, 0, 0
    for (g, p), depth, c in zip(grids, (2, 2, 18, 2), (128, 256, 512, 1024)):
        tp, t = p[0] * p[1], g[0] * g[1]
        core = 4 * 49 * tp * c
        total += depth * (8 * tp * c * c + core + 16 * t * c * c)
        cores += depth * core
        nbytes += 16 * depth * 4 * tp * c * 2
    for (g, _), c in zip(grids[1:], (128, 256, 512)):  # the mergings
        total += 2 * g[0] * g[1] * 4 * c * 2 * c
    backbone = total
    total += sum(2 * g[0] * g[1] * (c * 256 + 256 * 256 * 9)
                 for (g, _), c in zip(grids, (128, 256, 512, 1024)))
    total += (54400 + 13600 + 3400 + 850 + 221) * (2 * 256 * 256 * 9 + 2 * 256 * 15)
    assert counts_swin.forward_flops(cfg, hw) == total
    assert round(backbone / 1e8) == 5597 and round(total / 1e8) == 7377
    ms, by = counts_swin.attn_bound(16, cfg, hw)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert round(nbytes / 1e7) == 766 and ms > 16 * cores / 989e12 * 1e3
    assert swin.level_shapes(cfg, hw) == [(200, 272), (100, 136), (50, 68), (25, 34), (13, 17)]


def small():
    wl = copy.deepcopy(harness.workload(CELL))
    cfg = copy.deepcopy(harness.config(wl["config"]))
    cfg.update(SMALL)
    cfg["init"] = dict(cfg["init"], linear_weight=0.05)
    wl["traffic"].update(batch=4, pool=8, raw_h=60, raw_w=96)
    wl["warmup"] = 1
    wl["check"].update(sample_images=8, block=4)
    return wl, cfg


@pytest.mark.parametrize("kind", ["sound", "control", "no_shift", "unmasked", "no_bias",
                                  "truncated"])
def test_the_cell_judges_the_faults(kind):
    torch.set_num_threads(8)
    wl, cfg = small()
    hooks = None if kind == "sound" else readings_swin.hooks(torch, kind, cfg, "cpu")
    rec = serve_swin.run(torch, wl, cfg, SEED, 0.3, False, "cpu", harness.Spans(), hooks)
    rec["setup_s"] = 1.0
    result, _ = pb_run.result_line(harness.benchmark(), CELL, wl, rec, False, 1, "cpu")
    assert set(result["metrics"]) >= {"setup_s", "serve_img_per_s", "serve_batch_p95_ms"}
    assert result["correct"] == (kind == "sound"), result["checks"]


def test_traced_run_on_the_cpu_reports_no_device_metric():
    wl, cfg = small()
    wl["traffic"].update(batch=2, pool=4)
    wl.update(trace={"warmup": 1, "iters": 2})
    wl["check"].update(sample_images=2, block=2)
    rec = serve_swin.run(torch, wl, cfg, SEED, 0.2, True, "cpu", harness.Spans())
    rec["setup_s"] = 1.0
    result, _ = pb_run.result_line(harness.benchmark(), CELL, wl, rec, True, 1, "cpu")
    assert result["correct"]
    st = rec["program"]
    assert st["ops"] is None and not st["complete"]
    names = {s[0] for s in st["spans"]}
    assert names == {"rpn.predict", "rpn.upload", "rpn.stem", "rpn.backbone", "rpn.attn.layout",
                     "rpn.attn.window", "rpn.attn.shifted", "rpn.pyramid", "rpn.head",
                     "rpn.decode", "rpn.select"}
    assert not any(m.startswith("swin.") for m in result["metrics"])
    assert rec["bounds_ms"]["swin_attn"] > 0 and rec["bounds_ms"]["proposal"] > 0


def test_readers_on_a_stretch():
    spans = [("rpn.predict", None, 0, 1000), ("rpn.backbone", 0, 100, 600),
             ("rpn.attn.layout", 1, 110, 140), ("rpn.attn.window", 1, 150, 200),
             ("rpn.attn.layout", 1, 200, 220), ("rpn.attn.layout", 1, 280, 300),
             ("rpn.attn.shifted", 1, 300, 400), ("rpn.pyramid", 0, 600, 700),
             ("rpn.select", 0, 800, 900)]
    ops = [("gemm", 105, 125, 102, 1), ("pad", 120, 130, 112, 1),
           ("fmha_w", 160, 190, 160, 1), ("gather", 205, 215, 203, 1),
           ("gather", 290, 300, 285, 1), ("fmha_s", 310, 390, 310, 1),
           ("conv", 610, 650, 605, 1), ("proposal_kernel_levels", 820, 870, 810, 1)]
    from portbench import program

    st = {"iters": 1, "window_ns": (0, 1000), "spans": spans, "ops": ops}
    st.update(program.self_check(st, {"proposal_kernel": 1}))
    rec = {"program": st, "bounds_ms": {"swin_attn": 55e-6}}

    def read(name):
        spec = importlib.util.spec_from_file_location(name, harness.ROOT / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read(rec)

    assert read("swin.backbone_ms") == pytest.approx(160e-6)
    assert read("swin.layout_ms") == pytest.approx(30e-6)
    assert read("swin.attn_ms") == pytest.approx(110e-6)
    assert read("swin.attn.roofline_pct") == pytest.approx(50.0)
    rec["program"] = {**st, "complete": False}
    assert all(read(n) is None for n in ("swin.backbone_ms", "swin.layout_ms", "swin.attn_ms",
                                         "swin.attn.roofline_pct"))
    rec["program"] = st
    del rec["bounds_ms"]  # a record without the bound (another cell's): no share
    assert read("swin.attn.roofline_pct") is None


def test_new_modules_load_nothing_forbidden():
    probe = ("import sys; sys.path.insert(0, %r); import portbench.drivers.serve_swin, "
             "portbench.readings_swin, portbench.counts_swin, portbench.reference.swin; "
             "from portbench import harness; print(','.join(harness.forbidden_modules()))"
             % str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, timeout=300)
    assert out.stdout.strip() == ""
    ref = ("import sys; sys.path.insert(0, %r); import portbench.reference.swin, "
           "portbench.counts_swin; print(sorted({m.split('.')[0] for m in sys.modules} & "
           "{'tpurpn_torch', 'tpurpn', 'jax'}))" % str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", ref], capture_output=True, text=True, check=True,
                         timeout=300)
    assert out.stdout.strip() == "[]"


def test_config_holds_the_published_settings():
    cfg = harness.config("swin_b-800-serve")
    assert (cfg["embed_dim"], cfg["depths"], cfg["num_heads"]) == (128, [2, 2, 18, 2],
                                                                  [4, 8, 16, 32])
    assert (cfg["window_size"], cfg["mlp_ratio"], cfg["patch_size"], cfg["ln_eps"]) == (
        7, 4.0, 4, 1e-5)
    assert cfg["reduced"] == []
    assert cfg["fpn_in_channels"] == [s["dim"] for s in swin.stages(cfg)] == [128, 256, 512, 1024]
    assert (cfg["min_size_test"], cfg["max_size_test"], cfg["size_divisibility"]) == (800, 1333, 32)
    assert (cfg["fpn_channels"], cfg["head_convs"]) == (256, 1)
    hw = swin.canvas(480, 640, cfg)[1]
    anc, lev = swin.anchors(cfg, hw)
    assert anc.shape[0] == lev.shape[0] == cfg["anchors"] == 217413
    shapes = swin.param_shapes(cfg)
    backbone = sum(torch.Size(s).numel() for k, s in shapes.items() if k.startswith("backbone."))
    assert 86.7e6 < backbone < 86.8e6  # one card holds it whole
