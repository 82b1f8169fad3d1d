"""Background-thread batch prefetching and the copy to the device.

Counterpart of nsgp_repre_tpu/datasets/prefetch.py. A worker thread
keeps ``buffer_size`` batches ready and runs ``transfer_fn`` on each, so
decoding and the host-to-device copy of batch N+1 overlap the step on
batch N.

:func:`to_device` is the runner's ``transfer_fn``. On the CPU it returns
the batch as it is. On a CUDA device each tensor is copied from its own
freshly pinned buffer (PyTorch's pinned allocator keeps a buffer until
the copies queued from it have ended) with ``non_blocking=True`` on a
side stream, and an event is recorded after the copies; the batch
travels as an :class:`InFlight`, and the consumer's :meth:`InFlight.wait`
makes its current stream wait on that event and marks the tensors as
used by that stream, so the allocator does not hand their memory back to
the side stream while the compute stream still reads them.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional

import torch


def _map(x, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn`` over every tensor of a (nested) dataclass of tensors."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return fn(x)
    return dataclasses.replace(x, **{f.name: _map(getattr(x, f.name), fn)
                                     for f in dataclasses.fields(x)})


def _tensors(x) -> Iterator[torch.Tensor]:
    """Every tensor of a (nested) dataclass of tensors."""
    if isinstance(x, torch.Tensor):
        yield x
    elif x is not None:
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


class InFlight:
    """A batch whose copy to the card was queued on a side stream."""

    def __init__(self, value, event: torch.cuda.Event, device: torch.device):
        self.value, self.event, self.device = value, event, device

    def wait(self):
        """The batch, once the current stream has been made to wait for its copies."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self.event)
        for t in _tensors(self.value):
            t.record_stream(cur)
        return self.value


def to_device(x, device: torch.device, stream: Optional[torch.cuda.Stream] = None):
    """A dataclass of CPU tensors (DetBatch, InstanceArray) on ``device``:
    itself on the CPU; on CUDA, pinned non-blocking copies on ``stream``
    (an :class:`InFlight`), or on the current stream when ``stream`` is None."""
    if device.type != "cuda":
        return x

    def copy(t: torch.Tensor) -> torch.Tensor:
        return t.pin_memory().to(device, non_blocking=True)

    if stream is None:
        return _map(x, copy)
    with torch.cuda.stream(stream):
        out = _map(x, copy)
        event = torch.cuda.Event()
        event.record(stream)
    return InFlight(out, event, device)


class PrefetchLoader:
    """Wrap a DetLoader; a worker thread keeps ``buffer_size`` batches ready.

    ``transfer_fn`` (optional) is applied to each batch INSIDE the worker
    thread; an :class:`InFlight` result is waited for as the batch is
    handed out.
    """

    def __init__(self, loader, buffer_size: int = 2, transfer_fn=None):
        self.loader = loader
        self.buffer_size = buffer_size
        self.transfer_fn = transfer_fn

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.buffer_size)
        sentinel = object()
        error = []
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put so a consumer that stopped iterating early
            # releases the worker
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.loader:
                    if self.transfer_fn is not None:
                        batch, meta = item
                        item = (self.transfer_fn(batch), meta)
                    if not put(item):
                        return
            except BaseException as e:  # surface worker errors to the consumer
                error.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                batch, meta = item
                yield (batch.wait() if isinstance(batch, InFlight) else batch), meta
        finally:
            stop.set()
            while True:  # drain so the worker's pending put unblocks
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()
        if error:
            raise error[0]
