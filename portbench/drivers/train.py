"""Training as the trainer runs it by default: ``make_train_step(hp,
augment=True)`` fed by ``data.Prefetcher`` over the native SyntheticVOC
generator, shuffled from the seed, one step after another without a host
sync (a step's pageable upload of its frames waits for the last).

The harness makes the initial leaves on the card from the seed (one normal
draw, LeCun-scaled, zero biases) and each step's flip mask and selection
words with its own generator on the card, and passes both to the program
and, for the first three steps, to the reference. Those three steps are the
set-up's warm-up, taken through the window's own call and feed on rows that
all differ; the window then goes on with the same state.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from .. import check, counts, harness
from ..reference import nets
from ..reference import train as ref_train

CHECK_STEPS = 3


def leaves(torch, names_shapes, seed: int, dev) -> dict:
    """LeCun-normal weights (std 1/sqrt(fan_in)) and zero biases, from one
    draw."""
    g = torch.Generator(device=dev).manual_seed(seed)
    total = sum(int(np.prod(s)) for _, s in names_shapes)
    flat = torch.randn(total, generator=g, device=dev, dtype=torch.float32)
    out, o = {}, 0
    for name, shape in names_shapes:
        n = int(np.prod(shape))
        v = flat[o:o + n].view(shape)
        if len(shape) == 1:
            v.zero_()
        else:
            v.mul_(1.0 / float(np.sqrt(np.prod(shape[1:]))))
        out[name], o = v, o + n
    return out


def build_program(torch, cfg: dict, p0: dict, dev):
    import tpurpn_torch as T
    from tpurpn_torch.model import to_device

    hp = T.get_hyper_params(cfg["backbone"], img_size=cfg["img_size"],
                            total_pos_bboxes=cfg["total_pos_bboxes"],
                            total_neg_bboxes=cfg["total_neg_bboxes"],
                            compute_dtype=cfg["compute_dtype"])
    with torch.device(dev):
        model = T.get_model(hp)
    model = to_device(model, dev)
    params = dict(model.named_parameters())
    if set(params) != set(p0):
        raise RuntimeError(f"the program's leaves differ from the configuration's: "
                           f"{sorted(set(params) ^ set(p0))[:5]}")
    with torch.no_grad():
        for k, v in p0.items():
            params[k].copy_(v)
    state = T.create_train_state(
        hp, model=model,
        optimizer=lambda ps: T.default_optimizer(ps, learning_rate=cfg["learning_rate"]))
    return hp, state, T.make_train_step(hp, augment=cfg["augment"])


def run(torch, wl, cfg, seed, seconds, trace, dev, spans, hooks=None):
    hooks = hooks or {}
    tr = wl["traffic"]
    B = tr["batch"]
    s_w, s_data, s_shuffle, s_draw = harness.seeds(seed)
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    from tpurpn_torch.data import Prefetcher, SyntheticVOC

    p0 = leaves(torch, nets.vgg16_names(), s_w, dev)
    hp, state, step = build_program(torch, cfg, p0, dev)
    step = hooks.get("step", lambda s: s)(step)
    n = hp.total_anchors
    ds = SyntheticVOC(num_samples=tr["dataset"], raw_h=tr["raw_h"], raw_w=tr["raw_w"],
                      max_boxes=tr["max_boxes"], min_boxes=tr["min_boxes"], seed=s_data)
    it = Prefetcher(ds.batches(B, repeat=True, shuffle=s_shuffle), depth=tr["prefetch"])
    gen = torch.Generator(device=dev).manual_seed(s_draw)
    waits = []

    def one(record=None):
        t = time.perf_counter()
        with spans("pb.next"):
            imgs, boxes, labels = (torch.from_numpy(a) for a in next(it))
        waits.append(time.perf_counter() - t)
        with spans("pb.draws"):
            flip = torch.rand((B,), generator=gen, device=dev) < 0.5
            words = torch.randint(-(2 ** 31), 2 ** 31, (B, 2, n), generator=gen, device=dev,
                                  dtype=torch.int32)
        if record is not None:
            record.append((imgs.to(dev), boxes.to(dev), labels.to(dev), flip, words))
        with spans("pb.step"):
            return step(state, imgs, boxes, labels, flip=flip, rand_bits=words)[1]

    # set-up: the first steps, which the reference follows
    batches, prog = [], {"losses": []}
    params = dict(state.model.named_parameters())
    for s in range(CHECK_STEPS):
        m = one(batches)
        prog["losses"].append(float(m["loss"]))
        if s == 0:
            mom = state.optimizer.state
            prog["grad1"] = {k: float(mom[p]["momentum_buffer"].norm()) if p in mom else 0.0
                             for k, p in params.items()}
    prog["change"] = {k: float((p.detach() - p0[k]).norm()) for k, p in params.items()}
    sync()
    gc.collect()

    losses = []
    waits.clear()
    start_epoch = time.time()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < seconds:
        losses.append(one()["loss"])
        steps += 1
    sync()
    t_end = time.perf_counter()
    rec = {"images": steps * B, "steps": steps, "window_s": t_end - t0,
           "window_start": start_epoch, "chips": 1, "images_per_iter": B,
           "data_wait_s": list(waits),
           "flops_per_image": counts.forward_flops(cfg["backbone"], cfg["img_size"])}
    nonfinite = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    if trace:
        expected = {"targets_kernel": 1} if cuda else {}
        rec["trace"] = harness.trace_stretch(
            torch, lambda i: one(), wl["trace"]["iters"], wl["trace"]["warmup"], spans,
            expected, sync)
        rec["bounds_ms"] = {"targets": counts.targets_bound(B, n, tr["max_boxes"])[0]}
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    del state, step, params, losses, it
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = ref_train.steps(p0, batches, cfg)
    rec["numbers"] = {**check.train_numbers(prog, ref), "nonfinite_losses": nonfinite}
    rec["readings"] = {"program_losses": prog["losses"], "reference_losses": ref["losses"]}
    return rec
