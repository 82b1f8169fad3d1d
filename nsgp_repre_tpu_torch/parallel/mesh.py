"""Data parallelism on torch.distributed: one process per GPU.

Counterpart of nsgp_repre_tpu/parallel/mesh.py (``maybe_init_distributed``,
``shard_batch``, ``replicate``) and of the JAX runner's process helpers
(``_is_main``, ``_barrier``, ``_fetch``; runner.py:845-866). The
reference's only parallelism is DDP over NCCL (SURVEY §2.7). JAX puts the
global batch on a 1-D mesh and lets XLA insert the collectives; here each
rank holds the contiguous rows ``[r·B/W, (r+1)·B/W)`` of every global batch
(datasets/loader.py, ``num_shards``/``shard_id``) and a replica of the
parameters, and the code calls the collectives where JAX's global arrays
need them:

- the loss normalizers are summed over the ranks and the sampling draws
  are drawn at the global batch shape, each rank taking its rows
  (models/detector.py), so a rank computes its share of the global loss;
- the train and importance steps average the gradients (engine/train.py);
- the covariance taps average the batch-mean input before the outer
  product (models/layers.py);
- the teacher's and validation's detections and the RoI store's
  candidates are gathered in rank order (:func:`all_gather_rows`), so every
  rank holds the global rows, as JAX's ``_fetch`` gives them.

With no process group up every function is the identity or a no-op, so
one-process code keeps its bits.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, List, Optional, Sequence, TypeVar, Union

import numpy as np
import torch
import torch.distributed as dist

T = TypeVar("T")


def _env_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def maybe_init_distributed(backend: Optional[str] = None,
                           device: Optional[Union[str, torch.device]] = None,
                           init_method: Optional[str] = None,
                           timeout_s: Optional[float] = None) -> Optional[torch.device]:
    """Join the process group torchrun describes (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` for the default
    ``env://`` rendezvous) and return this rank's device.

    ``WORLD_SIZE`` unset or 1 starts no group and returns ``device`` as
    named (None stays None: the entry point's default applies). Otherwise
    the device is ``device`` (a bare ``cuda`` means ``cuda:LOCAL_RANK``),
    else ``cuda:LOCAL_RANK``; the backend is ``backend``, else ``nccl`` for
    a CUDA device and ``gloo`` for the CPU. Nothing is switched silently:
    a CUDA device without CUDA raises. A group already up is kept.
    """
    world = _env_world()
    if world <= 1:
        return None if device is None else torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        if not torch.cuda.is_available():
            raise RuntimeError(f"WORLD_SIZE={world} on {dev}, but there is no CUDA device: "
                               "pass device='cpu' to train on the CPU")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=init_method or "env://", world_size=world,
                                rank=int(os.environ["RANK"]), **kw)
    return dev


def is_distributed() -> bool:
    """Whether a process group is up (of any size, one included)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The number of ranks; 1 without a group. Raises when ``WORLD_SIZE``
    asks for several processes and no group is up: each would otherwise
    train alone on the whole data and write the same files."""
    if is_distributed():
        return dist.get_world_size()
    if _env_world() > 1:
        raise RuntimeError(
            f"WORLD_SIZE={_env_world()} but no process group is up: call "
            "nsgp_repre_tpu_torch.parallel.mesh.maybe_init_distributed() before building a runner")
    return 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main() -> bool:
    """Rank 0: the one that writes files (JAX's ``_is_main``)."""
    return rank() == 0


def barrier(tag: str = "") -> None:
    """Every rank waits here, so none reads a file before rank 0 has
    written it (JAX's ``sync_global_devices(tag)``); ``tag`` names the
    point in a hang's traceback."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def main_write(fn: Callable[[], T], tag: str) -> Optional[T]:
    """Rank 0 writes, every rank then waits: ``fn()`` runs on rank 0 only
    (the one that writes files; every rank computed the same contents),
    then :func:`barrier` ``(tag)``, so no rank reads the file early.
    Returns ``fn``'s result on rank 0 and None elsewhere."""
    out = fn() if is_main() else None
    barrier(tag)
    return out


def shard_rows(x, rank: int, world: int):
    """Rank ``rank``'s contiguous rows ``[r·n/W, (r+1)·n/W)`` of a
    global-batch tensor, or of every tensor of a (nested) dataclass of
    them such as a DetBatch (JAX's ``shard_batch``)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        n = x.shape[0]
        if n % world:
            raise ValueError(f"{n} rows do not divide over {world} ranks")
        b = n // world
        return x[rank * b:(rank + 1) * b]
    return dataclasses.replace(x, **{f.name: shard_rows(getattr(x, f.name), rank, world)
                                     for f in dataclasses.fields(x)})


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast every parameter and buffer from rank 0 (JAX's ``replicate``)."""
    if is_distributed():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, as a new tensor (no gradient flows
    through it); ``x`` itself without a group."""
    if not is_distributed():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (a sum, then a division by W)."""
    if not is_distributed():
        return x
    return all_reduce_sum(x) / dist.get_world_size()


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` over the ranks in place: one flat all-reduce per
    (dtype, device), then a division by W."""
    if not is_distributed():
        return
    W = dist.get_world_size()
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        flat.div_(W)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_gather_rows(arrays: Sequence) -> List[np.ndarray]:
    """Each array's rows from every rank, concatenated in rank order, as
    numpy arrays on the host (JAX's ``_fetch`` of a sharded array; the
    reference's ``all_gather_different_shape``). The arrays are each rank's
    fixed-shape padded block, so with rank r holding the global rows
    ``[r·B/W, (r+1)·B/W)`` the result is the global batch's rows in order.
    They travel through host memory (``all_gather_object``): gloo gathers
    no CUDA tensor, and these arrays end on the host anyway."""
    host = [a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in arrays]
    if not is_distributed():
        return host
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, host)
    return [np.concatenate([p[i] for p in parts]) for i in range(len(host))]


def check_same_rows(n: int, what: str) -> None:
    """Raise unless every rank passes the same ``n``: averaging per-rank
    means gives the global mean only over blocks of one size."""
    if not is_distributed():
        return
    sizes = [None] * dist.get_world_size()
    dist.all_gather_object(sizes, int(n))
    if len(set(sizes)) != 1:
        raise RuntimeError(f"{what}: the ranks hold {sizes} rows; the global mean needs equal blocks")
