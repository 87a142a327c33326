"""The port's trainer and predictor CLIs, in process on the CPU (``--device
cpu``, 64x64 images): a trainer -> predictor round trip through a checkpoint
directory, full and weights-only resume, the trained ``.npz`` in the
predictor, the random-init warning, and the refusals (missing weights, a
non-finite loss, the flags not ported yet)."""

import json
import os

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


@pytest.mark.parametrize("flag", ["--data-parallel", "--device-data"])
def test_trainer_refuses_the_flags_not_ported(workdir, flag):
    with pytest.raises(SystemExit, match="ROADMAP.md queue 1 item 8") as e:
        cli.trainer_main(["--backbone", "vgg16", *TRAIN, flag])
    assert flag in str(e.value)


def test_trainer_tensorboard_scalars(workdir, capsys):
    pytest.importorskip("tensorboardX")
    cli.trainer_main(["--backbone", "vgg16", *TRAIN, "--output-dir", str(workdir),
                      "--tensorboard", "--val-dataset", "synthetic"])
    (log,) = (workdir / "logs" / "vgg16").iterdir()
    assert any(p.name.startswith("events.out.tfevents") for p in log.iterdir())
    assert tpurpn_torch.__version__ and "epoch 1/1" in capsys.readouterr().out
