"""The key of the port's CUDA-graph cache (``engine/graphs.py``): what a
captured graph depends on besides its input buffers' values.  A call whose
key matches replays the graph; one whose key differs captures anew.  The
key is built on the host, so it is checked here on the CPU; the captures
and replays themselves are checked on the card
(``tests/test_torch_surface_graph.py``, ``tests/test_torch_outer_graph.py``).
Imports no JAX."""
import pytest
import torch

from selfreconcode_tpu_torch.engine.graphs import GraphCache


def _state():
    """Inputs, a read tensor, a leaf with a .grad and a static constant."""
    leaf = torch.nn.Parameter(torch.randn(3, 2))
    leaf.grad = torch.zeros_like(leaf)
    return dict(inputs={"x": torch.randn(4, 3), "i": torch.arange(4)},
                reads=[torch.randn(5)], leaves=[leaf], static=("cfg", 10))


def _values_in_place(st):
    """New values where the graph reads them: a replay sees them."""
    st["inputs"]["x"].add_(1.0)
    st["reads"][0].mul_(2.0)
    st["leaves"][0].data.add_(1.0)
    st["leaves"][0].grad.add_(1.0)


def _input_shape(st):
    st["inputs"]["x"] = torch.randn(5, 3)


def _input_dtype(st):
    st["inputs"]["x"] = st["inputs"]["x"].double()


def _reloaded_read(st):
    st["reads"][0].data = st["reads"][0].data.clone()


def _new_grad(st):
    # the old .grad kept alive, so that the new one cannot take its address
    st["old_grad"] = st["leaves"][0].grad
    st["leaves"][0].grad = torch.zeros_like(st["leaves"][0])


def _grad_gained(st):
    st["leaves"].append(torch.nn.Parameter(torch.randn(2)))
    before = GraphCache.key(**st)
    st["leaves"][-1].grad = torch.zeros(2)
    return before


def _static(st):
    st["static"] = ("cfg", 11)


@pytest.mark.parametrize("change, same", [
    (_values_in_place, True), (_input_shape, False), (_input_dtype, False),
    (_reloaded_read, False), (_new_grad, False), (_grad_gained, False),
    ("tf32", False), ("deterministic", False), (_static, False)],
    ids=lambda v: v if isinstance(v, str) else getattr(v, "__name__", v))
def test_graph_key(change, same):
    """The key stays with new values written in place and changes with an
    input's shape or dtype, a read tensor's or a .grad's storage, a leaf
    that gains a .grad, TF32, deterministic algorithms and the static
    constants."""
    torch.manual_seed(0)
    st = _state()
    before = GraphCache.key(**st)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    det = torch.are_deterministic_algorithms_enabled()
    try:
        if change == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = not tf32
        elif change == "deterministic":
            torch.use_deterministic_algorithms(not det)
        else:
            before = change(st) or before
        st.pop("old_grad", None)
        after = GraphCache.key(**st)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.use_deterministic_algorithms(det)
    assert (after == before) is same
