"""The port's trainer and predictor CLIs, in process on the CPU (``--device
cpu``, 64x64 images): a trainer -> predictor round trip through a checkpoint
directory, full and weights-only resume, the trained ``.npz`` in the
predictor, the random-init warning, the refusals (missing weights, a
non-finite loss), and the trainer's data-parallel (a group of one, and
two ranks under ``torch.distributed.run``) and device-resident routes
against the single-device host loop."""

import json
import os
import subprocess
import sys

import pytest
import torch

import tpurpn_torch
from tpurpn_torch import cli, io_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED_NPZ = os.path.join(REPO, "trained", "rpn_mobilenet_v2_trained.npz")
TRAIN = ["--img-size", "64", "--epochs", "1", "--steps-per-epoch", "2", "--batch-size", "4",
         "--learning-rate", "0.001", "--device", "cpu"]


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the trainer logs under ./logs
    return tmp_path


def test_trainer_then_predictor_roundtrip(workdir, capsys):
    out_dir = str(workdir / "trained")
    cli.trainer_main(["--backbone", "mobilenet_v2", *TRAIN, "--output-dir", out_dir,
                      "--eval-recall-every", "1"])
    out = capsys.readouterr().out
    assert "saved best checkpoint" in out and "val_recall@300=" in out
    ckpt = os.path.join(out_dir, "rpn_mobilenet_v2")
    assert os.listdir(ckpt) == ["state.pt"]
    (log,) = (workdir / "logs" / "mobilenet_v2").iterdir()
    rec = json.loads((log / "metrics.jsonl").read_text())
    assert rec["epoch"] == 1 and 0.0 <= rec["val_recall"] <= 1.0 and rec["val_loss"] > 0

    cli.predictor_main(["--backbone", "mobilenet_v2", "--img-size", "64", "--batch-size", "8",
                        "--weights", ckpt, "--output-dir", out_dir, "--fast",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored checkpoint" in out and "proposal recall@300 (IoU>=0.5): " in out
    assert "ignoring" not in out  # a folded mobilenet_v2 keeps --fast
    assert os.path.exists(os.path.join(out_dir, "proposals_mobilenet_v2.png"))

    # resume: the full train state, optimizer and step included
    cli.trainer_main(["--backbone", "mobilenet_v2", *TRAIN, "--output-dir", out_dir,
                      "--weights", ckpt])
    out = capsys.readouterr().out
    assert "resumed full train state" in out and "(step 2)" in out
    # a checkpoint of weights only resumes the weights, and says why
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)
    io_utils.save_checkpoint(ckpt, {"params": saved["params"],
                                    "batch_stats": saved["batch_stats"]})
    cli.trainer_main(["--backbone", "mobilenet_v2", *TRAIN, "--output-dir", out_dir,
                      "--weights", ckpt])
    out = capsys.readouterr().out
    assert "resumed weights ONLY" in out and "KeyError" in out


def test_predictor_on_the_trained_npz(workdir, capsys):
    cli.predictor_main(["--backbone", "mobilenet_v2", "--img-size", "64", "--batch-size", "16",
                        "--weights", TRAINED_NPZ, "--output-dir", str(workdir), "--fast",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loaded .npz weights (0 params missing)" in out
    line = next(ln for ln in out.splitlines() if "proposal recall@300 (IoU>=0.5): " in ln)
    rec = float(line.split(": ")[1].split()[0])
    assert 0.0 < rec <= 1.0 and line.endswith("GT boxes")
    png = workdir / "proposals_mobilenet_v2.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_predictor_random_init_warns_and_vgg16_drops_fast(workdir, capsys):
    cli.predictor_main(["--backbone", "vgg16", "--img-size", "64", "--batch-size", "32",
                        "--weights", str(workdir / "missing"), "--output-dir", str(workdir),
                        "--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "using random init" in out and "ignoring" in out
    assert "proposal recall@300" in out


def test_trainer_takes_keras_weights(workdir, capsys):
    cli.trainer_main(["--backbone", "mobilenet_v2", *TRAIN, "--output-dir", str(workdir),
                      "--weights", TRAINED_NPZ, "--no-augment", "--no-shuffle"])
    out = capsys.readouterr().out
    assert "weights-only resume; 0 entries not in file" in out
    assert "saved best checkpoint" in out


def test_trainer_rejects_missing_weights(workdir):
    with pytest.raises(FileNotFoundError, match="refusing"):
        cli.trainer_main(["--backbone", "mobilenet_v2", *TRAIN,
                          "--weights", str(workdir / "nope.ckpt")])


def test_trainer_nan_guard_fails_loudly(workdir):
    with pytest.raises(FloatingPointError, match="non-finite training loss at epoch 1 step 1"):
        cli.trainer_main(["--backbone", "vgg16", *TRAIN[:-6], "--learning-rate", "nan",
                          "--batch-size", "2", "--device", "cpu",
                          "--output-dir", str(workdir)])
    assert not (workdir / "rpn_vgg16").exists()  # nothing saved


def _epoch_record(workdir, monkeypatch, backbone, flags):
    """Train 2 epochs of 2 steps (shuffled, augmented) in ``workdir`` and
    return the metrics.jsonl records."""
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    cli.trainer_main(["--backbone", backbone, *TRAIN[:3], "2", *TRAIN[4:],
                      "--output-dir", str(workdir / "trained"), *flags])
    (log,) = (workdir / "logs" / backbone).iterdir()
    return [json.loads(line) for line in (log / "metrics.jsonl").read_text().splitlines()]


def _same_losses(a, b):
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert (x["loss"], x["val_loss"]) == (y["loss"], y["val_loss"])


@pytest.mark.parametrize("backbone", ["vgg16", "mobilenet_v2"])
def test_trainer_data_parallel_group_of_one_matches_one_device(tmp_path, monkeypatch,
                                                               capsys, backbone):
    """--data-parallel under a plain launch: a gloo group of one on the CPU
    whose losses are the single-device run's, and which it takes down after."""
    ref = _epoch_record(tmp_path / "single", monkeypatch, backbone, [])
    got = _epoch_record(tmp_path / "dp", monkeypatch, backbone, ["--data-parallel"])
    assert "data-parallel over 1 ranks" in capsys.readouterr().out
    _same_losses(got, ref)
    assert not torch.distributed.is_initialized()


def test_trainer_device_data_matches_the_host_loop(tmp_path, monkeypatch, capsys):
    """--device-data: the training set stacked on the device and the steps
    chained (the eager loop on the CPU) over the host iterator's shuffled
    rows with the same generator: the host loop's losses."""
    ref = _epoch_record(tmp_path / "host", monkeypatch, "mobilenet_v2", [])
    got = _epoch_record(tmp_path / "dev", monkeypatch, "mobilenet_v2", ["--device-data"])
    assert "device-resident training data: (256, 375, 500, 3) uint8" in capsys.readouterr().out
    _same_losses(got, ref)


def test_trainer_device_data_and_data_parallel_together(tmp_path, monkeypatch, capsys):
    ref = _epoch_record(tmp_path / "host", monkeypatch, "vgg16", [])
    got = _epoch_record(tmp_path / "both", monkeypatch, "vgg16",
                        ["--device-data", "--data-parallel", "--eval-recall-every", "1"])
    out = capsys.readouterr().out
    assert "sharded over 1 ranks" in out and "val_recall@300=" in out
    _same_losses(got, ref)
    with pytest.raises(SystemExit, match="--grad-accum does not combine"):
        cli.trainer_main(["--backbone", "vgg16", *TRAIN, "--device-data", "--grad-accum", "2"])


def test_trainer_under_torchrun_two_ranks(tmp_path, monkeypatch):
    """The launch users run: ``torch.distributed.run --standalone`` (a free
    port on localhost) starts two ranks of rpn_trainer_torch.py
    --data-parallel on the CPU (gloo). Rank 0 alone prints, logs and saves,
    and the epoch's losses are the single-device run's (VGG16: no
    BatchNorm; the ranks' bf16 forwards and the summed gradients round
    differently, so within rel 1e-3)."""
    ref = _epoch_record(tmp_path / "single", monkeypatch, "vgg16", [])
    run = tmp_path / "torchrun"
    run.mkdir()
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         os.path.join(REPO, "rpn_trainer_torch.py"), "--backbone", "vgg16", *TRAIN[:3], "2",
         *TRAIN[4:], "--output-dir", str(run / "trained"), "--data-parallel"],
        cwd=run, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.count("data-parallel over 2 ranks") == 1
    assert os.listdir(run / "trained" / "rpn_vgg16") == ["state.pt"]
    (log,) = (run / "logs" / "vgg16").iterdir()  # one rank logs
    got = [json.loads(line) for line in (log / "metrics.jsonl").read_text().splitlines()]
    assert len(got) == len(ref) == 2
    for x, y in zip(got, ref):
        for k in ("loss", "val_loss"):
            assert x[k] == pytest.approx(y[k], rel=1e-3), k


def test_trainer_tensorboard_scalars(workdir, capsys):
    pytest.importorskip("tensorboardX")
    cli.trainer_main(["--backbone", "vgg16", *TRAIN, "--output-dir", str(workdir),
                      "--tensorboard", "--val-dataset", "synthetic"])
    (log,) = (workdir / "logs" / "vgg16").iterdir()
    assert any(p.name.startswith("events.out.tfevents") for p in log.iterdir())
    assert tpurpn_torch.__version__ and "epoch 1/1" in capsys.readouterr().out
