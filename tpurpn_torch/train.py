"""Training on one GPU: the RPN train step (port of ``tpurpn/train.py``).

Rebuild of the reference's training logic (rpn_trainer.py +
utils/train_utils, SURVEY.md §3.1). One step does, on the device:

  uint8 batch -> preprocess (resize, flip) -> target assignment (the CUDA
  kernel ``kernels.targets.fused_rpn_targets``) -> forward in train mode ->
  masked smooth-L1 + BCE losses -> backward -> SGD with momentum.

State lives in torch objects, updated in place: ``TrainState`` holds the
model (parameters and BatchNorm running statistics), the optimizer and the
step count. Randomness comes from an explicit ``torch.Generator``: per step
the flip mask, then the (B, 2, N) selection words. torch cannot reproduce
``tpurpn``'s ``fold_in(key, step)`` draws, so a step also takes ``flip`` and
``rand_bits`` explicitly; parity tests replay ``tpurpn``'s that way.

Data parallelism (``tpurpn``'s GSPMD mesh) is ``torch.distributed``: one
process per device, a 1-D ``DeviceMesh`` with axis "data"
(``make_data_mesh``; NCCL on the card, gloo on the CPU), each rank holding
its rows of the global batch (``shard_batch``) and an identical copy of the
state (``replicate``). The mesh step computes the single-device update over
the global batch: global random draws, global loss normalizers, BatchNorm
statistics over every rank's rows and gradients summed over the ranks.

``make_scan_train_steps`` chains steps over a device-resident dataset: on
the card one CUDA graph of the step body, replayed once a step.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .anchors import generate_anchors
from .config import HyperParams
from .data import preprocess_batch
from .backbones.mobilenet_v2 import global_batch_statistics
from .losses import cls_valid_count, reg_loss, reg_pos_count, rpn_cls_loss
from .model import RPN, default_device, get_model, init_model
from .profiling import span
from .target import calculate_rpn_actual_outputs, target_rand_bits


@dataclasses.dataclass
class TrainState:
    """The model (parameters + BatchNorm statistics), its optimizer and the
    number of steps taken."""

    model: RPN
    optimizer: torch.optim.Optimizer
    step: int = 0


def default_optimizer(
    params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-3
) -> torch.optim.Optimizer:
    """SGD with momentum 0.9, no dampening: ``optax.sgd(lr, momentum=0.9)``
    (trace = g + 0.9 trace; p -= lr trace)."""
    return torch.optim.SGD(params, lr=learning_rate, momentum=0.9)


def create_train_state(
    hp: HyperParams,
    generator: Optional[torch.Generator] = None,
    optimizer: Optional[Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]] = None,
    model: Optional[RPN] = None,
    device=None,
) -> TrainState:
    """A fresh state: ``model`` (default: ``get_model(hp)`` initialized from
    ``generator`` on ``device``, default cuda) and ``optimizer(params)``
    (default: ``default_optimizer``)."""
    if model is None:
        model = init_model(get_model(hp), generator, device)
    make_opt = optimizer or default_optimizer
    return TrainState(model=model, optimizer=make_opt(model.parameters()))


def _model_device(model: RPN) -> torch.device:
    return next(model.parameters()).device


class _Anchors:
    """The anchor grid of ``hp`` on each device it is asked for."""

    def __init__(self, hp: HyperParams):
        self.hp = hp
        self._by_device: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self._by_device:
            self._by_device[device] = generate_anchors(self.hp, device)
        return self._by_device[device]


def _draw_flip(generator: Optional[torch.Generator], batch: int) -> torch.Tensor:
    if generator is None:
        raise ValueError("augment=True needs a generator or an explicit flip mask")
    return torch.rand((batch,), generator=generator, device=generator.device) < 0.5


def _targets(hp, anchors, images_u8, gt_boxes, gt_labels, flip, rand_bits, augment,
             use_kernel):
    """Preprocess and target assignment on given draws: parameter-free,
    shared by the step variants and the eval loss."""
    images, boxes = preprocess_batch(
        images_u8, gt_boxes, hp.img_size, augment=augment, flip=flip
    )
    deltas, labels = calculate_rpn_actual_outputs(
        anchors, boxes, gt_labels, hp, rand_bits=rand_bits.to(anchors.device),
        use_kernel=use_kernel,
    )
    return images, deltas, labels


# ---------------------------------------------------------------------------
# the data-parallel mesh: torch.distributed, one process per device
# ---------------------------------------------------------------------------


def make_data_mesh(n_devices: Optional[int] = None, device=None):
    """1-D "data" ``DeviceMesh`` over the ranks of the default process group,
    one process per device (``tpurpn.train.make_data_mesh``'s counterpart).

    Without a process group it makes one: under ``torchrun`` (``RANK`` and
    ``MASTER_ADDR`` in the environment) the group the launcher describes,
    otherwise a group of this process alone, on a file store of its own. The
    backend is NCCL for ``device`` cuda (the default; each rank on the GPU
    ``LOCAL_RANK`` mod the GPUs present) and gloo for cpu. A group made by
    the caller is used as it is. ``n_devices`` other than the group's size
    raises.
    """
    from torch.distributed.device_mesh import init_device_mesh

    dev_type = default_device(device).type
    if not dist.is_initialized():
        if dev_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
        backend = "nccl" if dev_type == "cuda" else "gloo"
        if "RANK" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend)
        else:
            fd, path = tempfile.mkstemp(prefix="tpurpn_torch_store_")
            os.close(fd)
            dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0,
                                    world_size=1)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"n_devices={n_devices}, but the process group has {world} ranks: launch one "
            f"process per device (torchrun --nproc-per-node {n_devices})"
        )
    return init_device_mesh(dev_type, (world,), mesh_dim_names=("data",))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(mesh, *arrays):
    """This rank's rows of global host batches, on its device: rows
    [r*B/D, (r+1)*B/D) of each (numpy arrays or tensors), the row split of
    ``tpurpn``'s ``P("data")``. Every rank passes the same global batch (each
    runs the same seeded loader)."""
    r, d = mesh.get_local_rank(), mesh.size()
    dev = _mesh_device(mesh)
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % d:
            raise ValueError(f"a batch of {t.shape[0]} rows does not divide among {d} ranks")
        n = t.shape[0] // d
        out.append(t[r * n:(r + 1) * n].to(dev))
    return tuple(out) if len(out) > 1 else out[0]


@torch.no_grad()
def replicate(mesh, state: TrainState) -> TrainState:
    """Move ``state`` to this rank's device and give every rank rank 0's
    parameters, buffers (BatchNorm statistics), optimizer state and step.
    Raises on every rank if the ranks' states differ in structure."""
    dev = _mesh_device(mesh)
    model, opt = state.model.to(dev), state.optimizer
    for st in opt.state.values():
        for k, v in st.items():
            if torch.is_tensor(v):
                st[k] = v.to(dev)
    tensors = [*model.parameters(), *model.buffers(), *_optimizer_tensors(opt)]
    group, src = mesh.get_group(), int(mesh.mesh.reshape(-1)[0])
    meta = torch.tensor([len(tensors), -len(tensors), state.step], device=dev)
    sizes = meta[:2].clone()
    dist.all_reduce(sizes, op=dist.ReduceOp.MAX, group=group)
    if int(sizes[0]) != -int(sizes[1]):
        raise ValueError("the ranks' train states hold different numbers of tensors: "
                         "build every rank's state the same way")
    dist.broadcast(meta, src, group=group)
    state.step = int(meta[2])
    for t in tensors:
        dist.broadcast(t, src, group=group)
    return state


def _optimizer_tensors(opt: torch.optim.Optimizer):
    return [v for st in opt.state.values() for v in st.values() if torch.is_tensor(v)]


def _sum_gradients(model: RPN, group) -> None:
    """All-reduce (sum) the parameters' gradients as one flat buffer."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()


def _global_counts(deltas, labels, group):
    """max(1, count) of the positives and of the counted anchors over the
    global batch: the full-batch losses' denominators."""
    counts = torch.stack([reg_pos_count(deltas), cls_valid_count(labels)])
    dist.all_reduce(counts, group=group)
    return torch.clamp(counts, min=1.0).unbind()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


class _Step:
    """``make_train_step``'s step: the draws for the global batch, then one
    update on this rank's rows."""

    def __init__(self, hp: HyperParams, augment: bool, grad_accum: int, use_kernel, mesh):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if grad_accum > 1 and mesh is not None:
            raise NotImplementedError(
                "grad_accum under a mesh is not supported: accumulation exists to fit a "
                "big batch on one device; with a mesh, shard the batch instead"
            )
        self.hp, self.augment, self.grad_accum, self.use_kernel = hp, augment, grad_accum, use_kernel
        self.anchors = _Anchors(hp)
        self.group = None if mesh is None else mesh.get_group()
        self.rank, self.ranks = (0, 1) if mesh is None else (mesh.get_local_rank(), mesh.size())

    def draws(self, generator, flip, rand_bits, batch: int):
        """(flip, rand_bits) of this rank's ``batch`` rows. What is not given
        is drawn from ``generator`` for the global batch of batch x ranks
        rows, in the single-device order: the flip mask (with augment), then
        the (B, 2, N) selection words. Given draws are the global batch's."""
        total = batch * self.ranks
        if not self.augment:
            flip = None
        elif flip is None:
            flip = _draw_flip(generator, total)
        if rand_bits is None:
            if generator is None:
                raise ValueError("pass rand_bits or a generator to draw them from")
            rand_bits = target_rand_bits(generator, total, self.hp.total_anchors)
        for name, t in (("flip", flip), ("rand_bits", rand_bits)):
            if t is not None and t.shape[0] != total:
                raise ValueError(f"{name} has {t.shape[0]} rows for a global batch of {total}")
        rows = slice(self.rank * batch, (self.rank + 1) * batch)
        return (None if flip is None else flip[rows]), rand_bits[rows]

    def update(self, state: TrainState, images_u8, gt_boxes, gt_labels, flip, rand_bits
               ) -> Dict[str, torch.Tensor]:
        """One SGD update on the given draws; ``state.step`` is not counted."""
        model, opt = state.model, state.optimizer
        dev = _model_device(model)
        B = images_u8.shape[0]
        if B % self.grad_accum:
            raise ValueError(f"batch {B} not divisible by grad_accum {self.grad_accum}")
        images, deltas, labels = _targets(
            self.hp, self.anchors.on(dev), images_u8.to(dev), gt_boxes.to(dev),
            gt_labels.to(dev), flip, rand_bits, self.augment, self.use_kernel,
        )
        was_training = model.training
        model.train()
        opt.zero_grad(set_to_none=True)
        num_pos = (labels == 1.0).sum()
        if self.group is not None:
            pos_norm, valid_norm = _global_counts(deltas, labels, self.group)
            with span("rpn.step.forward"):
                with global_batch_statistics(model, self.group):
                    rpn_reg, rpn_cls = model(images)
                l_reg = reg_loss(deltas, rpn_reg, normalizer=pos_norm)
                l_cls = rpn_cls_loss(labels, rpn_cls, normalizer=valid_norm)
            with span("rpn.step.backward"):
                (l_reg + l_cls).backward()
                _sum_gradients(model, self.group)
            sums = torch.stack([l_reg.detach(), l_cls.detach(), num_pos.float()])
            dist.all_reduce(sums, group=self.group)
            l_reg, l_cls, num_pos = sums[0], sums[1], sums[2].long()
            loss = l_reg + l_cls
        elif self.grad_accum == 1:
            with span("rpn.step.forward"):
                rpn_reg, rpn_cls = model(images)
                l_reg = reg_loss(deltas, rpn_reg)
                l_cls = rpn_cls_loss(labels, rpn_cls)
                loss = l_reg + l_cls
            with span("rpn.step.backward"):
                loss.backward()
            l_reg, l_cls, loss = l_reg.detach(), l_cls.detach(), loss.detach()
        else:
            # the full-batch loss's denominators
            pos_norm = torch.clamp(reg_pos_count(deltas), min=1.0)
            valid_norm = torch.clamp(cls_valid_count(labels), min=1.0)
            mb = B // self.grad_accum
            l_reg = l_cls = loss = torch.zeros((), device=dev)
            for i in range(self.grad_accum):
                sl = slice(i * mb, (i + 1) * mb)
                with span("rpn.step.forward"):
                    rpn_reg, rpn_cls = model(images[sl])
                    m_reg = reg_loss(deltas[sl], rpn_reg, normalizer=pos_norm)
                    m_cls = rpn_cls_loss(labels[sl], rpn_cls, normalizer=valid_norm)
                with span("rpn.step.backward"):
                    (m_reg + m_cls).backward()  # .grad sums over the microbatches
                l_reg = l_reg + m_reg.detach()
                l_cls = l_cls + m_cls.detach()
                loss = loss + (m_reg + m_cls).detach()
        with span("rpn.step.update"):
            opt.step()
        model.train(was_training)
        return {"loss": loss, "reg_loss": l_reg, "cls_loss": l_cls, "num_pos": num_pos}

    def __call__(self, state: TrainState, images_u8, gt_boxes, gt_labels, generator=None, *,
                 flip=None, rand_bits=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("rpn.step"):
            flip, rand_bits = self.draws(generator, flip, rand_bits, images_u8.shape[0])
            metrics = self.update(state, images_u8, gt_boxes, gt_labels, flip, rand_bits)
        state.step += 1
        return state, metrics


def make_train_step(
    hp: HyperParams,
    augment: bool = True,
    grad_accum: int = 1,
    use_kernel: bool | None = None,
    mesh=None,
):
    """Build the train step.

    step(state, images_u8 (B,H,W,3), gt_boxes (B,M,4), gt_labels (B,M),
         generator=None, *, flip=None, rand_bits=None) -> (state, metrics)

    The inputs move to the model's device. ``generator`` draws what is not
    given: the (B,) flip mask (with ``augment``), then the (B, 2, N) int32
    selection words. ``use_kernel`` is ``calculate_rpn_actual_outputs``'
    (None: the CUDA target kernel on the card). The state is updated in place
    and returned; metrics (``loss``, ``reg_loss``, ``cls_loss``, ``num_pos``)
    are 0-dim tensors on the device, read without a host sync.

    ``grad_accum=n > 1`` splits the batch into n microbatches for the
    forward and backward, bounding activation memory at batch/n. The
    accumulation is exact: targets are computed once on the full batch, each
    microbatch loss is normalized by the global counts, and the gradients
    are summed, so the update equals the full-batch one up to float
    reduction order. BatchNorm sees microbatches, as in ``tpurpn``.

    With ``mesh`` (``make_data_mesh``) every rank calls the step on its rows
    of the global batch (``shard_batch``) with a generator seeded alike on
    every rank, and the update equals the single-device update over the
    global batch up to float reduction order: the draws are the global
    batch's (this rank takes its rows; given ``flip`` / ``rand_bits`` are
    global too), the losses divide by the global positive and counted-anchor
    counts, BatchNorm takes statistics over every rank's rows, and the
    gradients are summed over the ranks. The metrics are the global values on
    every rank. ``grad_accum > 1`` with a mesh raises NotImplementedError, as
    in ``tpurpn``.
    """
    return _Step(hp, augment, grad_accum, use_kernel, mesh)


def _stacked(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([metrics["loss"], metrics["reg_loss"], metrics["cls_loss"],
                        metrics["num_pos"].float()])


class _StepGraph:
    """The train step captured once in a CUDA graph and replayed once a step.

    The graph reads its batch from the device-resident dataset through a
    static row index and its draws from static buffers, all written before
    each replay; the generator stays outside it. It is captured after one
    eager step, which counts as a step, creates SGD's momentum buffers and
    warms up cuDNN and the kernels, following torch's whole-network capture
    (the step's ``zero_grad(set_to_none=True)`` inside the captured region),
    and captured again when a tensor of the state or of the dataset moves.
    A failing capture raises. ``captures`` and ``replays`` count both."""

    def __init__(self, step: _Step):
        self.step = step
        self.key = None
        self.captures = self.replays = 0

    @staticmethod
    def _key(state: TrainState, data):
        tensors = (*data, *state.model.parameters(), *state.model.buffers(),
                   *_optimizer_tensors(state.optimizer))
        return (id(state.model), id(state.optimizer)) + tuple(t.data_ptr() for t in tensors)

    def _update(self, state, data):
        batch = [t.index_select(0, self.idx) for t in data]
        return _stacked(self.step.update(state, *batch, self.flip, self.bits))

    def run(self, state: TrainState, data, rows, draws):
        out = []
        if self._key(state, data) != self.key:
            self.idx = rows[0].clone()
            self.flip, self.bits = (None if t is None else t.clone() for t in draws[0])
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out.append(self._update(state, data))
            torch.cuda.current_stream().wait_stream(side)
            state.step += 1
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._update(state, data)
            self.captures += 1
            self.key = self._key(state, data)
        for s in range(len(out), len(draws)):
            self.idx.copy_(rows[s])
            if self.flip is not None:
                self.flip.copy_(draws[s][0])
            self.bits.copy_(draws[s][1])
            self.graph.replay()
            self.replays += 1
            out.append(self.out.clone())
            state.step += 1
        return out


def _walk(step: _Step, n: int, batch_size: int, num_steps: int, origin: int,
          sample_idx, start_step) -> np.ndarray:
    """(num_steps, B/D) rows of this rank's n dataset rows that the steps
    take: the contiguous walk from ``origin`` (or ``start_step``), or the
    global ``sample_idx`` rebased to this rank's shard."""
    d, b = step.ranks, batch_size // step.ranks
    if sample_idx is None:
        if n % b:
            raise ValueError(
                f"dataset size {n} not divisible by batch_size {batch_size}: the host "
                "iterator drops the remainder; pad or trim the data, or pass explicit "
                "sample_idx" if step.group is None else
                f"per-shard size {n} not divisible by per-shard batch {b}: the contiguous "
                "walk would split a batch across epochs; pad/trim the data or pass "
                "sample_idx (data.sharded_batch_index_iter)"
            )
        pos = (origin if start_step is None else int(start_step)) + np.arange(num_steps)
        return ((pos * b) % n)[:, None] + np.arange(b)
    if start_step is not None:
        raise ValueError("sample_idx and start_step are mutually exclusive: "
                         "explicit rows already define the walk")
    idx = np.asarray(sample_idx.cpu() if torch.is_tensor(sample_idx) else sample_idx,
                     np.int64)
    if idx.shape != (num_steps, batch_size):
        raise ValueError(f"sample_idx shape {idx.shape} != (num_steps, batch_size) = "
                         f"({num_steps}, {batch_size})")
    local = idx.reshape(num_steps, d, b) - np.arange(d)[None, :, None] * n
    bad = (local < 0) | (local >= n)
    if bad.any():
        s, blk, j = np.argwhere(bad)[0]
        if step.group is None:
            raise ValueError(f"sample_idx row {idx[s, j]} at step {s} is outside the "
                             f"dataset's {n} rows")
        raise ValueError(
            f"sample_idx violates shard locality: batch position block {blk} must index "
            f"rows [{blk * n}, {(blk + 1) * n}) (its device's shard), got row "
            f"{idx[s, blk * b + j]} at step {s} — generate walks with "
            "data.sharded_batch_index_iter"
        )
    return local[:, step.rank]


def make_scan_train_steps(
    hp: HyperParams,
    augment: bool = True,
    *,
    batch_size: int,
    num_steps: int,
    mesh=None,
):
    """Chain ``num_steps`` train steps over a device-resident dataset (the
    counterpart of ``tpurpn``'s one jitted ``lax.scan``).

    run(state, generator, images_u8 (N,H,W,3), gt_boxes (N,M,4),
        gt_labels (N,M), sample_idx=None, start_step=None)
        -> (state, metrics)  [metrics: (num_steps,) tensors on the device]

    Exactly a host loop of ``make_train_step``'s step with the same
    generator over the same rows: the draws of all steps come from
    ``generator`` first, in the loop's order (it advances in place), and
    step s takes rows [(s*B) % N, ... + B) of the dataset, s counted from
    ``state.step`` (N must divide by B), or from ``start_step``; or the
    (num_steps, B) rows of ``sample_idx`` (``data.batch_index_iter`` rows
    replay shuffled epochs). Pass the dataset on the model's device.

    On the card the steps are one CUDA graph of the step body
    (``_StepGraph``), replayed once a step after an eager first step; the
    batch is gathered inside the graph. On the CPU they run eagerly.

    With ``mesh`` each rank passes its shard of the dataset (rows
    [r*N/D, (r+1)*N/D), ``shard_batch``) and walks it: batch block r (rows
    [r*B/D, (r+1)*B/D) of each global batch) comes from shard r, the
    contiguous walk per shard. ``sample_idx`` stays the global (num_steps, B)
    rows, each block within its shard (``data.sharded_batch_index_iter``);
    it is checked and rebased. The steps are ``make_train_step(mesh=...)``'s,
    so a host loop of it over the same global rows computes the same.
    """
    if batch_size < 1 or num_steps < 1:
        raise ValueError(
            f"batch_size and num_steps must be >= 1, got {batch_size}, {num_steps}"
        )
    step = _Step(hp, augment, 1, None, mesh)
    if batch_size % step.ranks:
        raise ValueError(
            f"batch_size {batch_size} not divisible by the mesh's {step.ranks} devices"
        )
    b_local = batch_size // step.ranks
    graph = _StepGraph(step)

    def run(state: TrainState, generator, images_u8, gt_boxes, gt_labels, sample_idx=None,
            start_step=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        rows = _walk(step, images_u8.shape[0], batch_size, num_steps, state.step,
                     sample_idx, start_step)
        draws = [step.draws(generator, None, None, b_local) for _ in range(num_steps)]
        dev = _model_device(state.model)
        data = tuple(t.to(dev) for t in (images_u8, gt_boxes, gt_labels))
        rows = torch.from_numpy(rows).to(dev)
        if dev.type == "cuda":
            out = graph.run(state, data, rows, draws)
        else:
            out = []
            for s in range(num_steps):
                batch = [t.index_select(0, rows[s]) for t in data]
                out.append(_stacked(step.update(state, *batch, *draws[s])))
                state.step += 1
        out = torch.stack(out)
        return state, {"loss": out[:, 0], "reg_loss": out[:, 1], "cls_loss": out[:, 2],
                       "num_pos": out[:, 3].long()}

    run.graph = graph
    return run


def make_eval_loss_fn(hp: HyperParams, mesh=None):
    """Validation loss without gradients: the quantity the reference's
    ModelCheckpoint(save_best_only=True) monitors.

    eval_loss(state, images_u8, gt_boxes, gt_labels, generator=None, *,
              rand_bits=None) -> 0-dim loss tensor

    No augmentation; BatchNorm uses its running statistics. With ``mesh``
    each rank passes its rows of the global batch, the words are the global
    batch's (as ``make_train_step``'s) and every rank gets the global loss.
    """
    step = _Step(hp, False, 1, None, mesh)

    @torch.no_grad()
    def eval_loss(state: TrainState, images_u8, gt_boxes, gt_labels, generator=None, *,
                  rand_bits=None) -> torch.Tensor:
        model = state.model
        dev = _model_device(model)
        _, rand_bits = step.draws(generator, None, rand_bits, images_u8.shape[0])
        images, deltas, labels = _targets(
            hp, step.anchors.on(dev), images_u8.to(dev), gt_boxes.to(dev), gt_labels.to(dev),
            None, rand_bits, False, None,
        )
        was_training = model.training
        model.eval()
        rpn_reg, rpn_cls = model(images)
        model.train(was_training)
        if step.group is None:
            return reg_loss(deltas, rpn_reg) + rpn_cls_loss(labels, rpn_cls)
        pos_norm, valid_norm = _global_counts(deltas, labels, step.group)
        sums = torch.stack([reg_loss(deltas, rpn_reg, normalizer=pos_norm),
                            rpn_cls_loss(labels, rpn_cls, normalizer=valid_norm)])
        dist.all_reduce(sums, group=step.group)
        return sums[0] + sums[1]

    return eval_loss


def get_step_size(total_items: int, batch_size: int) -> int:
    """Mirror of the reference's ``train_utils.get_step_size`` (ceil division)."""
    return -(-total_items // batch_size)


def rpn_generator(dataset, anchors: torch.Tensor, hp: HyperParams,
                  generator: torch.Generator, *, batch_size: int = 8,
                  augment: bool = True) -> Iterator:
    """API-parity port of the reference's ``train_utils.rpn_generator``:
    an endless generator of ``(images, (bbox_deltas, bbox_labels))`` batches
    on ``anchors``' device, the structure the reference feeds to Keras
    ``model.fit``. ``make_train_step`` does this work inside the step."""
    dev = anchors.device
    for raw_imgs, gt_boxes, gt_labels in dataset.batches(batch_size, repeat=True):
        B = raw_imgs.shape[0]
        flip = _draw_flip(generator, B) if augment else None
        images, deltas, labels = _targets(
            hp, anchors, torch.from_numpy(raw_imgs).to(dev),
            torch.from_numpy(gt_boxes).to(dev), torch.from_numpy(gt_labels).to(dev),
            flip, target_rand_bits(generator, B, anchors.shape[0]), augment, None,
        )
        yield images, (deltas, labels)

