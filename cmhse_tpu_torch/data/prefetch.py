"""Host-to-device batch pipeline, counterpart of ``_prefetch`` in
``cmhse_tpu/train/loop.py`` (``device_put`` is asynchronous there, so the
next batches move while the current step runs).

On a CUDA device each batch is copied with ``non_blocking`` copies on one
side stream, ``LOOKAHEAD`` batches ahead of the consumer (two, as in the
JAX loop). A field that is already a page-locked CPU tensor (the loader's
``frames``, packed straight into pinned memory) is copied from where it
lies: a ``non_blocking`` copy records its event on the caching host
allocator's block, which is then not handed out again before the copy has
ended. Every other field is staged in a ring of ``LOOKAHEAD + 1``
page-locked host buffers, reused from batch to batch; before a buffer is
refilled, the host waits for the copy that last read from it. The
consumer's stream waits on an event recorded after each batch's copies (a
device-side wait: the host does not block), and each device tensor is
marked with ``record_stream`` so that the caching allocator does not hand
its memory out again while that stream may still read it.

On the CPU the batches are handed over as they are: there is nothing to
copy, and :meth:`Batch.to` on the CPU shares the numpy arrays' memory.

With the recorder on (:mod:`cmhse_tpu_torch.utils.timing`), a batch's
``prefetch.pin`` span covers filling its slot, with a ``prefetch.slot_wait``
span inside it around the wait for the slot's last copy (counted in
``prefetch.slot_waits`` when that copy had not ended); ``prefetch.bytes``
counts every byte a batch sends to the device, ``prefetch.direct_bytes``
those sent straight from pinned batch fields; ``prefetch.copy`` covers
issuing its copies. Each
batch keeps the key the loader gave it, and handing it over makes that key
the consumer's, so the step that trains on it shares it.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Iterable, Iterator

import torch

from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.utils import timing

FIELDS = tuple(f.name for f in dataclasses.fields(Batch))
LOOKAHEAD = 2


def _identity(item):
    return item


class _PinnedSlot:
    """One host staging buffer a field that needs one, grown as needed and
    reused, and the event of the copy that last read from it."""

    def __init__(self) -> None:
        self.buffers: dict[str, torch.Tensor] = {}
        self.event: torch.cuda.Event | None = None

    def fill(self, batch: Batch) -> dict[str, torch.Tensor]:
        with timing.span("prefetch.pin"):
            return self._fill(batch)

    def _fill(self, batch: Batch) -> dict[str, torch.Tensor]:
        if self.event is not None:
            with timing.span("prefetch.slot_wait"):
                if timing.active() and not self.event.query():
                    timing.count("prefetch.slot_waits")
                self.event.synchronize()  # the last copy out of it has ended
        out, direct = {}, 0
        for name in FIELDS:
            src = getattr(batch, name)
            if isinstance(src, torch.Tensor) and src.is_pinned():
                out[name] = src  # copied as it lies (module docstring)
                direct += src.nbytes
                continue
            src = torch.as_tensor(src)
            buf = self.buffers.get(name)
            if buf is None or buf.dtype != src.dtype or \
                    buf.numel() < src.numel():
                buf = torch.empty(src.numel(), dtype=src.dtype,
                                  pin_memory=True)
                self.buffers[name] = buf
            view = buf[:src.numel()].view(src.shape)
            view.copy_(src)
            out[name] = view
        if timing.active():
            timing.count("prefetch.bytes",
                         sum(v.nbytes for v in out.values()))
            timing.count("prefetch.direct_bytes", direct)
        return out


class Prefetcher:
    """Batches to ``device``, LOOKAHEAD ahead, from pinned memory (see
    the module docstring). One object keeps its ring and its copy stream
    across calls, so a training run pins its buffers once."""

    def __init__(self, device: str | torch.device) -> None:
        self.device = torch.device(device)
        self.slots = [_PinnedSlot() for _ in range(LOOKAHEAD + 1)]
        self.stream: torch.cuda.Stream | None = None  # made on first use

    def __call__(self, items: Iterable,
                 batch_of: Callable[..., Batch] = _identity
                 ) -> Iterator[tuple]:
        """Yield ``(item, batch)`` for each of ``items``, where ``batch`` is
        ``batch_of(item)`` (a host :class:`Batch`) on the device, ready for
        use on the current stream."""
        if self.device.type != "cuda":
            for item in items:
                yield item, batch_of(item)
            return
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        queue: deque = deque()
        for i, item in enumerate(items):
            slot = self.slots[i % len(self.slots)]
            pinned = slot.fill(batch_of(item))
            with timing.span("prefetch.copy"), \
                    torch.cuda.stream(self.stream):
                placed = {k: v.to(self.device, non_blocking=True)
                          for k, v in pinned.items()}
                slot.event = torch.cuda.Event()
                slot.event.record(self.stream)
            queue.append((item, placed, slot.event, timing.current_key()))
            if len(queue) >= LOOKAHEAD:
                yield self._hand_over(*queue.popleft())
        while queue:
            yield self._hand_over(*queue.popleft())

    def _hand_over(self, item, placed: dict, event: torch.cuda.Event,
                   key: int | None):
        timing.set_key(key)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        for t in placed.values():
            t.record_stream(compute)
        return item, Batch(**placed)

