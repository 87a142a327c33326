"""A run with the timed path broken underneath comes out not correct.

Each test drives a cell's driver on the CPU at a small size (the harness's
look for a card skipped), with the cell's own limits: the sound program
passes, and each fault the cell can have, and the control (the reference in
fp8 in the program's place), fails."""

import copy

import pytest
import torch

from portbench import harness, readings
from portbench import run as pb_run
from portbench.drivers import serve, train

SEED = 2 ** 31 + 977


def small_serve(cell):
    wl = copy.deepcopy(harness.workload(cell))
    cfg = copy.deepcopy(harness.config(wl["config"]))
    cfg["img_size"] = 64
    wl["traffic"].update(batch=4, pool=8, raw_h=48, raw_w=64)
    wl["warmup"] = 1
    wl["check"].update(sample_images=8, block=4)
    return wl, cfg


def small_train(cell):
    # at 128 px the program's bf16 and the fp8 control read as at 500 px
    # on the card (64 px blurs them together)
    wl = copy.deepcopy(harness.workload(cell))
    cfg = copy.deepcopy(harness.config(wl["config"]))
    cfg["img_size"] = 128
    wl["traffic"].update(batch=4, dataset=64, raw_h=96, raw_w=128)
    return wl, cfg


def correct(run, hooks_for, cell, small, kind):
    """A run's ``correct`` and checks, through the result line run.py prints."""
    torch.set_num_threads(8)
    wl, cfg = small(cell)
    hooks = None if kind == "sound" else hooks_for(torch, kind, cfg, "cpu")
    rec = run(torch, wl, cfg, SEED, 0.5, False, "cpu", harness.Spans(), hooks)
    rec["setup_s"] = 1.0
    result, _ = pb_run.result_line(harness.benchmark(), cell, wl, rec, False, wl["chips"], "cpu")
    assert set(result["metrics"]) >= {"setup_s"}
    return result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ("sound", "control") + readings.SERVE_FAULTS)
@pytest.mark.parametrize("cell", ["serve-b128", "serve-b8"])
def test_serve_faults(cell, kind):
    ok, checks = correct(serve.run, readings.serve_hooks, cell, small_serve, kind)
    assert ok == (kind == "sound"), checks


@pytest.mark.parametrize("kind", ("sound", "control") + readings.TRAIN_FAULTS)
def test_train_faults(kind):
    ok, checks = correct(train.run, readings.train_hooks, "train-b8", small_train, kind)
    assert ok == (kind == "sound"), checks

