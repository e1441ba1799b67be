"""The port's one CUDA-graph mechanism: ``GraphCache`` replays a function
of device tensors as one captured graph, which the host launches once in
place of its many small kernels.  The function reads nothing back to the
host; what changes between calls enters as its input tensors, copied into
the graph's static buffers.  Every other tensor it reads or writes is used
where it is, so in-place updates (Adam, ``copy_``, ``zero_grad(set_to_none=
False)``) reach the graph, and the key holds their addresses, so new
storage captures anew.  The training step (``trainer.make_train_step``)
alone decides what replays: it hands a cache to the code that replays, and
no cache means eager.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ..utils import trace


def _cloned(out):
    """out (a tensor, or a tuple or dict of them, nested), every tensor
    cloned out of the graph's buffers."""
    if torch.is_tensor(out):
        return out.clone()
    if isinstance(out, dict):
        return {k: _cloned(v) for k, v in out.items()}
    return tuple(_cloned(v) for v in out)


def _capture(fn, inputs: dict, leaves):
    """fn captured on clones of inputs: (graph, input buffers, outputs).
    The warm-up on a side stream (the autograd engine's device thread,
    cuBLAS's handles and workspaces exist before the capture) leaves each
    leaf's .grad as it found it; a leaf that had none and that fn gives one
    gets a zero .grad, so that the capture adds into it too."""
    buffers = {k: v.clone() for k, v in inputs.items()}
    before = [None if p.grad is None else p.grad.clone() for p in leaves]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(buffers)
    torch.cuda.current_stream().wait_stream(side)
    for p, g in zip(leaves, before):
        if g is not None:
            p.grad.copy_(g)
        elif p.grad is not None:
            p.grad = torch.zeros_like(p)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = fn(buffers)
    return graph, buffers, outputs


class GraphCache:
    """At most `bound` captured graphs, least recently used first (the
    bound frees the graphs of shapes or storage gone by).  Counts the host
    counters ``<prefix>_captures`` and ``<prefix>_replays`` (a call that
    replayed a graph captured earlier)."""

    def __init__(self, prefix: str, bound: int):
        self.prefix, self.bound = prefix, bound
        self.graphs: "OrderedDict[tuple, tuple]" = OrderedDict()

    @staticmethod
    def key(inputs: dict, reads=(), static=(), leaves=()) -> tuple:
        """What a graph depends on besides its input buffers' values: the
        inputs' device, shapes and dtypes, `static`, the switches that
        choose its kernels (TF32, deterministic algorithms), and the
        address and shape of `reads`, the leaves and their .grad."""
        held = [*reads, *leaves, *(p.grad for p in leaves)]
        return (static, str(next(iter(inputs.values())).device),
                torch.backends.cuda.matmul.allow_tf32,
                torch.are_deterministic_algorithms_enabled(),
                tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()),
                tuple(None if t is None else (t.data_ptr(), tuple(t.shape))
                      for t in held))

    def replay(self, fn, inputs: dict, reads=(), static=(), leaves=()):
        """fn(inputs) replayed from its graph, captured first where none
        has this key; its outputs (a tensor, or a tuple or dict of them)
        cloned.  inputs: device tensors; reads: the other tensors fn reads
        or writes in place; static: hashable constants fn closes over;
        leaves: the tensors whose .grad fn adds to."""
        key = self.key(inputs, reads, static, leaves)
        entry = self.graphs.pop(key, None)
        if entry is None:
            while len(self.graphs) >= self.bound:
                self.graphs.popitem(last=False)
            entry = _capture(fn, inputs, leaves)
            trace.count(f"{self.prefix}_captures")
            # the capture gave a .grad to each leaf that fn adds to
            key = self.key(inputs, reads, static, leaves)
        else:
            trace.count(f"{self.prefix}_replays")
        self.graphs[key] = entry
        graph, buffers, outputs = entry
        for k, v in inputs.items():
            buffers[k].copy_(v)
        graph.replay()
        return _cloned(outputs)
