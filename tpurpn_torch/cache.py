"""One rule for every tensor derived from parameters: a weight's copy in the
compute dtype, a folded or packed weight, an interpolated table.

A derived tensor is made once per version of its sources and reused until
one of them changes. The key is each source's identity, ``_version`` and
storage address: an in-place update (``copy_``, an optimizer step,
``load_state_dict``) bumps the version, a replaced parameter is another
object, and a new storage under the same parameter (``p.data = t``) moves
the address, so none of them is served a stale result.

A writer that changes a source's values without autograd's knowledge does
not bump its version: a CUDA graph's replay, a collective such as
``dist.broadcast``, a write into ``p.data`` in place. Such a writer must
call ``torch.autograd.graph.increment_version`` on what it wrote, as
``train._StepGraph.run`` does after its replays and ``train.replicate``
after its broadcasts.

Entries live as long as their first source: they are held under a weak
reference to it, so an entry is freed with its first source, and no
fixed-size store evicts a model's own weights. The other sources are held
until the entry is made again, so that an id is never reused while its
entry lives. There is one entry a (first source, tag): a new version
replaces the old one.

Inference tensors carry no version: what is derived from them is made
afresh at every call. Results are made outside inference mode and without
autograd, so that they can be sources in turn and hold no reference to
their sources' graph.

``derived`` and ``compute_copy`` add autograd's case: while autograd would
record (grad mode on and a source that requires grad), the result is made
at each use, so that training's gradients reach the f32 parameters.
"""

from __future__ import annotations

import operator
from typing import Callable, Hashable, Sequence, TypeVar

import torch
from torch.utils.weak import WeakIdKeyDictionary

T = TypeVar("T")

# first source -> {tag: (the other sources, their stamps, value)}
_entries = WeakIdKeyDictionary()
_generation = 0  # the number of clear() calls
_VERSION = operator.attrgetter("_version")


def _stamp(sources: Sequence[torch.Tensor]) -> tuple:
    return tuple((t._version, t.data_ptr()) for t in sources)


def _owned(value, sources):
    """``value`` with each tensor that is a source or a view of another
    tensor detached: a view holds its base, and an entry that held its own
    first source would never be freed."""
    if isinstance(value, torch.Tensor):
        if value._base is not None or any(value is s for s in sources):
            return value.detach()
        return value
    if isinstance(value, tuple):
        items = [_owned(v, sources) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") else tuple(items)
    return value


def cached(sources: Sequence[torch.Tensor], tag: Hashable, make: Callable[[], T]) -> T:
    """``make()`` (a tensor, or tuples of tensors and constants), computed
    once per version of ``sources`` (the module's rule) and kept under
    ``tag`` beside ``sources[0]``."""
    if any(t.is_inference() for t in sources):
        return make()
    first, rest = sources[0], tuple(sources[1:])
    stamp = _stamp(sources)
    slot = _entries.get(first)
    hit = None if slot is None else slot.get(tag)
    if (hit is not None and hit[1] == stamp and len(hit[0]) == len(rest)
            and all(a is b for a, b in zip(hit[0], rest))):
        return hit[2]
    with torch.inference_mode(False), torch.no_grad():
        value = _owned(make(), sources)
    if slot is None:
        slot = _entries[first] = {}
    slot[tag] = (rest, stamp, value)
    return value


def derived(sources: Sequence[torch.Tensor], tag: Hashable, make: Callable[[], T]) -> T:
    """``make()`` at each use while autograd would record it, else
    :func:`cached`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
        return make()
    return cached(sources, tag, make)


def compute_copy(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p.to(dtype)``: the same bits and memory format, made once per
    version of ``p`` outside autograd (:func:`derived`)."""
    if p.dtype == dtype:
        return p
    return derived((p,), dtype, lambda: p.to(dtype))


def clear() -> None:
    """Forget every entry (the next use makes each result afresh)."""
    global _generation
    _entries.clear()
    _generation += 1


def graph_key(tensors: Sequence[torch.Tensor], versions: bool = True):
    """When a CUDA graph that reads ``tensors`` at each replay, or what was
    derived from them, must be captured again: once this key differs. It is
    the module's rule, each tensor's identity and storage address, and with
    ``versions`` each ``_version`` and the number of :func:`clear` calls, so
    a graph never replays a derived tensor that :func:`cached` would make
    again. The caller holds ``tensors``, so that no id is reused. A graph
    whose own replays write ``tensors`` (a train step, which then bumps
    their versions) keys without ``versions``. None where a tensor is an
    inference tensor: it keeps no version, and nothing derived from it is
    kept."""
    ids = tuple(map(id, tensors))
    ptrs = tuple(map(torch.Tensor.data_ptr, tensors))
    if not versions:
        return ids, ptrs
    try:
        return ids, ptrs, tuple(map(_VERSION, tensors)), _generation
    except RuntimeError:  # an inference tensor keeps no version
        return None
