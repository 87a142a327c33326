"""CLI entry points of the port (port of ``tpurpn/cli.py``).

``rpn_trainer_torch.py`` / ``rpn_predictor_torch.py`` at the repository
root mirror the reference's invocation (``python rpn_trainer.py --backbone
vgg16``, SURVEY.md §2 rows 1-2) and delegate here. Both run on ``cuda``
unless ``--device`` names another device.

The trainer's ``--data-parallel`` runs one process per device under
``torchrun --nproc-per-node N rpn_trainer_torch.py --data-parallel ...``
(a plain ``python`` launch is a group of one): every rank loads the same
seeded batches and trains on its rows (``train.make_data_mesh``,
``shard_batch``); every rank runs the collective validation, and rank 0
alone prints, logs and saves. ``--device-data`` stacks the training set on
the device and chains ``NAN_CHECK_EVERY``-step chunks of
``train.make_scan_train_steps`` (one CUDA graph on the card); with
``--data-parallel`` each rank holds its shard.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import get_hyper_params
from .data import (Prefetcher, batch_index_iter, get_dataset, preprocess_batch,
                   sharded_batch_index_iter)
from .eval import proposal_recall
from .io_utils import (
    get_log_path,
    get_model_path,
    handle_args,
    handle_device_compatibility,
    load_checkpoint,
    load_keras_h5_weights,
    save_checkpoint,
)
from .model import fold_batch_norm, get_model, init_model
from .predict import make_predict_fn
from .train import (create_train_state, default_optimizer, make_data_mesh,
                    make_eval_loss_fn, make_scan_train_steps, make_train_step, replicate,
                    shard_batch)

NAN_CHECK_EVERY = 100


def _is_weights_file(path: str) -> bool:
    return path.endswith((".h5", ".npz"))


def _to_device(dev, *arrays):
    return tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in arrays)


def _model_state(model):
    """The model's parameters and its buffers (BatchNorm statistics), by name."""
    return ({n: p.detach() for n, p in model.named_parameters()},
            {n: b for n, b in model.named_buffers()})


def trainer_main(argv=None):
    args = handle_args(argv)
    owns_group = args.data_parallel and not dist.is_initialized()
    try:
        _train(args)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args):
    hp = get_hyper_params(args.backbone, img_size=args.img_size)
    dev = torch.device(args.device)
    mesh = None
    if args.data_parallel:
        mesh = make_data_mesh(device=dev)
        dev = torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev
    rank0 = mesh is None or mesh.get_local_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    if args.handle_gpu and rank0:  # reference parity: -handle-gpu
        handle_device_compatibility()
    say(f"[tpurpn_torch] device: {dev}")
    say(f"[tpurpn_torch] hyper_params: {hp}")

    train_ds = get_dataset(args.dataset, "train", max_boxes=hp.max_gt_boxes)
    val_source = args.val_dataset or args.dataset
    if args.val_dataset is None and args.dataset.endswith(".json"):
        # a COCO instances file has no split: without a separate
        # --val-dataset, "val_loss" would track the training data
        say("[tpurpn_torch] WARNING: --dataset is a COCO .json and no "
            "--val-dataset was given; val_loss is measured on the "
            "TRAINING annotations and best-checkpoint selection is "
            "not meaningful")
    val_ds = get_dataset(val_source, "validation", max_boxes=hp.max_gt_boxes)

    state = create_train_state(
        hp, torch.Generator().manual_seed(args.seed),
        optimizer=lambda p: default_optimizer(p, args.learning_rate), device=dev,
    )
    model, opt = state.model, state.optimizer
    if args.weights:  # resume from a previous checkpoint
        if not os.path.exists(args.weights):
            raise FileNotFoundError(
                f"--weights {args.weights!r} does not exist — refusing to "
                "silently train from random init"
            )
        if _is_weights_file(args.weights):
            _, missing = load_keras_h5_weights(args.weights, model)
            say(f"[tpurpn_torch] loaded Keras weights from {args.weights} "
                f"(weights-only resume; {len(missing)} entries not in file)")
        elif os.path.isdir(args.weights):
            # full train-state resume (weights, BN statistics, optimizer,
            # step); weights only when the checkpoint holds less
            params, stats = _model_state(model)
            like = {"params": params, "batch_stats": stats,
                    "opt_state": opt.state_dict(), "step": state.step}
            try:
                restored = load_checkpoint(args.weights, like)
                model.load_state_dict({**restored["params"], **restored["batch_stats"]})
                opt.load_state_dict(restored["opt_state"])
                state.step = int(restored["step"])
                say(f"[tpurpn_torch] resumed full train state from {args.weights} "
                    f"(step {state.step})")
            except (KeyError, ValueError, RuntimeError) as e:
                restored = load_checkpoint(
                    args.weights, {"params": params, "batch_stats": stats}, partial=True)
                model.load_state_dict({**restored["params"], **restored.get("batch_stats", {})},
                                      strict=False)
                # say WHY: a silently reset optimizer on a full checkpoint
                # would be invisible
                say(f"[tpurpn_torch] resumed weights ONLY (optimizer state and "
                    f"step reset) from {args.weights} — full-state restore "
                    f"failed with {type(e).__name__}: {e}")
        else:
            raise ValueError(
                f"--weights {args.weights!r} is neither a checkpoint "
                "directory nor a .h5 / .npz file"
            )

    if mesh is not None:
        state = replicate(mesh, state)
        say(f"[tpurpn_torch] data-parallel over {mesh.size()} ranks")
    if args.device_data and args.grad_accum > 1:
        raise SystemExit("--grad-accum does not combine with --device-data: the "
                         "device-resident steps take whole batches")
    step_fn = make_train_step(hp, augment=not args.no_augment, grad_accum=args.grad_accum,
                              mesh=mesh)
    eval_loss_fn = make_eval_loss_fn(hp, mesh=mesh)
    steps_per_epoch = args.steps_per_epoch or max(1, len(train_ds) // args.batch_size)
    ckpt_path = get_model_path(args.backbone, args.output_dir)
    log_path = get_log_path(args.backbone) if rank0 else None
    best_val = float("inf")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def on_device(*batch):
        """A global host batch on the device: this rank's rows under a mesh."""
        return _to_device(dev, *batch) if mesh is None else shard_batch(mesh, *batch)

    writer = None
    if args.tensorboard and rank0:
        from tensorboardX import SummaryWriter

        writer = SummaryWriter(log_path)

    def validation_loss():
        # a fixed generator per batch: the draws, and so the epochs' losses,
        # are comparable; under a mesh every rank takes part and gets the
        # global loss
        losses = []
        for batch in val_ds.batches(args.batch_size):
            losses.append(float(eval_loss_fn(
                state, *on_device(*batch), torch.Generator(device=dev).manual_seed(0))))
        return float(np.mean(losses)) if losses else None

    predict_fn = None

    def validation_recall():
        # recall@test_nms_topn, the north-star accuracy metric, beside the
        # val_loss that selects checkpoints
        nonlocal predict_fn
        if predict_fn is None:
            predict_fn = make_predict_fn(model, hp, device=dev, mesh=mesh)
        rec = gt = 0
        for imgs, boxes, labels in val_ds.batches(args.batch_size):
            imgs, boxes, labels = _to_device(dev, imgs, boxes, labels)
            x, b = preprocess_batch(imgs, boxes, hp.img_size)
            out = predict_fn(x if mesh is None else shard_batch(mesh, x))
            r = proposal_recall(out["roi_boxes"], out["num_valid"], b, labels)
            rec += int(r["num_recalled"])
            gt += int(r["num_gt"])
        return rec / max(1, gt)

    say(f"[tpurpn_torch] training {args.epochs} epochs x {steps_per_epoch} steps, "
        f"batch {args.batch_size}; logs: {log_path}")
    shuffle = None if args.no_shuffle else args.seed
    it = idx_it = None
    scan_runs = {}
    if args.device_data:
        # the whole training set on the device; steps chained in
        # NAN_CHECK_EVERY-step calls over the rows the host iterator would
        # take (batch_index_iter is its own index walk), with the same
        # generator: only the per-step upload goes
        try:
            data = next(train_ds.batches(len(train_ds)))
        except ValueError as e:
            raise SystemExit(
                "--device-data needs every raw image the same size (the set "
                f"is stacked into one device array): {e}") from None
        if mesh is None:
            idx_it = batch_index_iter(len(train_ds), args.batch_size, repeat=True,
                                      shuffle=shuffle)
        else:
            n_dev = mesh.size()
            if len(train_ds) % n_dev or args.batch_size % n_dev:
                raise SystemExit(
                    f"--device-data --data-parallel needs the dataset size "
                    f"({len(train_ds)}) and --batch-size ({args.batch_size}) "
                    f"to divide by the {n_dev} mesh devices")
            idx_it = sharded_batch_index_iter(len(train_ds), args.batch_size, n_dev,
                                              repeat=True, shuffle=shuffle)
        dev_data = on_device(*data)
        say(f"[tpurpn_torch] device-resident training data: {tuple(data[0].shape)} uint8 "
            f"({data[0].nbytes / 1e9:.2f} GB"
            + (f", sharded over {mesh.size()} ranks)" if mesh is not None else ")"))
    else:
        it = Prefetcher(train_ds.batches(args.batch_size, repeat=True, shuffle=shuffle),
                        depth=2)
    for epoch in range(args.epochs):
        t0 = time.time()
        # losses stay on the device between checks: a host sync every step
        # would stall the queue of launches; a non-finite loss is caught
        # within NAN_CHECK_EVERY steps
        losses, step_metrics, all_vals = [], [], []
        checked = 0

        def check_finite(upto):
            nonlocal checked
            if upto == checked:
                return
            vals = torch.stack(losses[checked:upto]).cpu().numpy()
            if not np.isfinite(vals).all():
                bad = checked + int(np.argmax(~np.isfinite(vals)))
                detail = ", ".join(
                    f"{k}={float(v):.6g}" for k, v in sorted(step_metrics[bad].items()))
                raise FloatingPointError(
                    f"non-finite training loss at epoch {epoch + 1} step "
                    f"{bad} ({detail}) — check learning rate / data; "
                    f"training state NOT saved"
                )
            all_vals.append(vals)
            checked = upto

        if args.device_data:
            done = 0
            while done < steps_per_epoch:
                nsteps = min(NAN_CHECK_EVERY, steps_per_epoch - done)
                run = scan_runs.get(nsteps)
                if run is None:
                    run = scan_runs[nsteps] = make_scan_train_steps(
                        hp, augment=not args.no_augment, batch_size=args.batch_size,
                        num_steps=nsteps, mesh=mesh)
                sample_idx = np.stack([next(idx_it) for _ in range(nsteps)])
                _, metrics = run(state, gen, *dev_data, sample_idx)
                vals = metrics["loss"].cpu().numpy()
                if not np.isfinite(vals).all():
                    bad = int(np.argmax(~np.isfinite(vals)))
                    detail = ", ".join(f"{k}={float(v[bad]):.6g}"
                                       for k, v in sorted(metrics.items()))
                    raise FloatingPointError(
                        f"non-finite training loss at epoch {epoch + 1} step "
                        f"{done + bad} ({detail}) — check learning rate / data; "
                        f"training state NOT saved")
                all_vals.append(vals)
                done += nsteps
        else:
            for _ in range(steps_per_epoch):
                _, metrics = step_fn(state, *on_device(*next(it)), gen)
                losses.append(metrics["loss"])
                step_metrics.append(metrics)
                if len(losses) - checked >= NAN_CHECK_EVERY:
                    check_finite(len(losses))
            check_finite(len(losses))
        # a zero-step epoch reports nan rather than crash on concatenate([])
        mean_loss = float(np.mean(np.concatenate(all_vals))) if all_vals else float("nan")
        if not all_vals:
            say("[tpurpn_torch] WARNING: epoch ran 0 training steps "
                f"(steps_per_epoch={steps_per_epoch}) — train loss is nan")
        val_loss = validation_loss()
        # degrade loudly, never silently skip every checkpoint
        if val_loss is None:
            say("[tpurpn_torch] WARNING: validation produced no batches "
                f"(batch_size {args.batch_size} > val set?) — monitoring "
                "the TRAIN loss for best-checkpoint selection")
            monitored = mean_loss
        else:
            if not np.isfinite(val_loss):
                say(f"[tpurpn_torch] WARNING: non-finite val_loss {val_loss} — "
                    "no checkpoint will be saved this epoch")
            monitored = val_loss
        val_recall = None
        if args.eval_recall_every and (epoch + 1) % args.eval_recall_every == 0:
            val_recall = validation_recall()
        dt = time.time() - t0
        ips = steps_per_epoch * args.batch_size / dt
        val_str = "n/a" if val_loss is None else f"{val_loss:.4f}"
        rec_str = "" if val_recall is None else f" val_recall@{hp.test_nms_topn}={val_recall:.4f}"
        say(f"[tpurpn_torch] epoch {epoch + 1}/{args.epochs} loss={mean_loss:.4f} "
            f"val_loss={val_str}{rec_str} ({ips:.1f} img/s)")
        rec = {"epoch": epoch + 1, "loss": mean_loss, "val_loss": val_loss,
               "images_per_sec": ips}
        if val_recall is not None:
            rec["val_recall"] = val_recall
        if rank0:
            with open(os.path.join(log_path, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
        if writer is not None:
            writer.add_scalar("loss/train", mean_loss, epoch + 1)
            if val_loss is not None:
                writer.add_scalar("loss/val", val_loss, epoch + 1)
            if val_recall is not None:
                writer.add_scalar("recall/val", val_recall, epoch + 1)
            writer.add_scalar("images_per_sec", ips, epoch + 1)
        # reference parity: ModelCheckpoint(save_best_only=True, monitor val);
        # the full train state, so a resume continues the optimizer
        if monitored < best_val:
            best_val = monitored
            if rank0:
                params, stats = _model_state(model)
                save_checkpoint(ckpt_path, {"params": params, "batch_stats": stats,
                                            "opt_state": opt.state_dict(), "step": state.step})
            say(f"[tpurpn_torch] saved best checkpoint -> {ckpt_path}")
    if writer is not None:
        writer.close()


def predictor_main(argv=None):
    args = handle_args(argv)
    hp = get_hyper_params(args.backbone, img_size=args.img_size)
    if args.handle_gpu:  # reference parity: -handle-gpu
        handle_device_compatibility()
    dev = torch.device(args.device)
    model = init_model(get_model(hp), torch.Generator().manual_seed(args.seed), device=dev)

    weights = args.weights or get_model_path(args.backbone, args.output_dir)
    if _is_weights_file(weights) and os.path.exists(weights):
        _, missing = load_keras_h5_weights(weights, model)
        print(f"[tpurpn_torch] loaded {os.path.splitext(weights)[1]} weights "
              f"({len(missing)} params missing)")
    elif os.path.isdir(weights):
        # partial: train checkpoints also hold opt_state and step
        params, stats = _model_state(model)
        restored = load_checkpoint(weights, {"params": params, "batch_stats": stats},
                                   partial=True)
        model.load_state_dict({**restored["params"], **restored.get("batch_stats", {})})
        print(f"[tpurpn_torch] restored checkpoint from {weights}")
    else:
        print(f"[tpurpn_torch] WARNING: no weights at {weights}; using random init")

    # fold BatchNorms into conv weights for inference (same math, faster)
    folded = hp.backbone == "mobilenet_v2"
    if folded:
        model = fold_batch_norm(model)
    fast = args.fast
    if fast and not folded:
        print("[tpurpn_torch] --fast needs a folded-BN mobilenet_v2; ignoring")
        fast = False
    predict = make_predict_fn(model, hp, fast=fast, device=dev)
    ds = get_dataset(args.dataset, "test", max_boxes=hp.max_gt_boxes)

    recalled = total_gt = 0
    first_batch = None
    for imgs, boxes, labels in ds.batches(args.batch_size):
        imgs, boxes, labels = _to_device(dev, imgs, boxes, labels)
        x, b = preprocess_batch(imgs, boxes, hp.img_size)
        out = predict(x)
        r = proposal_recall(out["roi_boxes"], out["num_valid"], b, labels)
        recalled += int(r["num_recalled"])
        total_gt += int(r["num_gt"])
        if first_batch is None:
            first_batch = (x[0].cpu().numpy(), out["roi_boxes"][0].cpu().numpy(),
                           int(out["num_valid"][0]))

    rec = recalled / max(1, total_gt)
    print(f"[tpurpn_torch] proposal recall@{hp.test_nms_topn} (IoU>=0.5): {rec:.4f} "
          f"over {total_gt} GT boxes")

    if first_batch is not None:
        from .drawing import draw_bboxes_to_file

        img, roi, nv = first_batch
        out_path = os.path.join(args.output_dir, f"proposals_{args.backbone}.png")
        os.makedirs(args.output_dir, exist_ok=True)
        draw_bboxes_to_file(img, roi[: min(50, nv)], out_path)
        print(f"[tpurpn_torch] drew top proposals -> {out_path}")
