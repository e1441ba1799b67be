"""Data parallelism over a torch.distributed process group (torch port of
``selfreconcode_tpu/parallel/sharded.py``).

The parameters are replicated; each rank takes a contiguous share of the
step's rays and points, and the gradients are summed over ranks in one
all-reduce.  JAX does this with ``shard_map`` and one ``psum``; here the
ranks are processes, one per device: NCCL for CUDA devices, gloo for the
CPU (the tests), and no other backend.  Rendezvous goes through a
``FileStore`` (a file under the run's folder), so runs side by side never
share a port.

Nothing wraps a module in ``DistributedDataParallel``: its reducer hooks
do not support the ``autograd.grad(create_graph=True)`` double backward of
``sdf_grad`` nor the trainer's two backward passes per step.  Gradients are
reduced explicitly after the backward (``allreduce_sum_``).

Without ``init_dp`` every call here is a no-op over a world of one.  The
training step (``engine/trainer.py``) is what uses these; JAX's
``make_train_step_sharded``, a toy step that only its dry run calls, has
its counterpart in the tests (``tests/torch_dp_workers.py``).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Sequence

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_dp(rank: int, world: int, device_kind: str, store_path: str) -> float:
    """Join the process group as `rank` of `world` over a FileStore at
    `store_path` (a file that does not exist yet, or is empty).  `cuda`:
    NCCL on cuda:<rank>; `cpu`: gloo.  A failure to initialise raises.
    Returns the seconds the set-up took, up to the first collective."""
    if device_kind not in BACKENDS:
        raise ValueError(f"data parallel runs on 'cuda' (NCCL) or 'cpu' "
                         f"(gloo), not {device_kind!r}")
    t0 = time.perf_counter()
    kw = {}
    if device_kind == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(BACKENDS[device_kind],
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, **kw)
    barrier()
    return time.perf_counter() - t0


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def device() -> torch.device:
    """The device the backend's collectives take tensors on."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier():
    """Wait until every rank arrives: a one-element all-reduce whose value
    the host reads (an NCCL collective is only enqueued on the stream)."""
    if dist.is_initialized():
        t = torch.zeros(1, device=device())
        dist.all_reduce(t)
        t.item()


@contextlib.contextmanager
def main_first():
    """Rank 0 runs the body first; the others run it once rank 0 is done
    (rank 0 writes a cache that the others then read)."""
    if not is_main():
        barrier()
    yield
    if is_main():
        barrier()


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict:
    groups: Dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def _collective_(tensors: Sequence[torch.Tensor], op):
    """Flatten the tensors of each dtype into one buffer on the backend's
    device, run op(buffer) on it, and copy the result back in place."""
    for dtype, group in _by_dtype(tensors).items():
        wire = torch.uint8 if dtype == torch.bool else dtype
        buf = torch.cat([t.detach().reshape(-1).to(device(), wire)
                         for t in group])
        op(buf)
        off = 0
        with torch.no_grad():
            for t in group:
                n = t.numel()
                t.copy_(buf[off:off + n].view(t.shape).to(t.device, dtype))
                off += n


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0):
    """Overwrite each tensor with rank `src`'s, in one broadcast per
    dtype."""
    if dist.is_initialized():
        _collective_(tensors, lambda buf: dist.broadcast(buf, src))


def allreduce_sum_(tensors: Sequence[torch.Tensor]):
    """Sum each tensor over the ranks, in place: one all-reduce of one
    flat buffer (per dtype)."""
    if dist.is_initialized():
        _collective_(tensors, lambda buf: dist.all_reduce(buf))


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors concatenated along dim 0 in rank order (their
    row counts may differ)."""
    if not dist.is_initialized():
        return t
    dev = device()
    n = torch.tensor([t.shape[0]], device=dev)
    counts = [torch.zeros_like(n) for _ in range(world())]
    dist.all_gather(counts, n)
    counts = [int(c) for c in counts]
    pad = t.new_zeros((max(counts),) + tuple(t.shape[1:]), device=dev)
    pad[:t.shape[0]] = t
    parts = [torch.empty_like(pad) for _ in counts]
    dist.all_gather(parts, pad)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(t.device)


def share(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous share of x's rows (``torch.tensor_split``)."""
    return torch.tensor_split(x, world())[rank()]
