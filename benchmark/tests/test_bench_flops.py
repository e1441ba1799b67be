"""step_mfu's FLOP count is of the algorithm and a lower bound of what the
port executes: on a tiny step (the published widths) it is at most the
matrix-product FLOPs the port runs, by torch's own FLOP formulas."""
import tempfile

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .conftest import tiny_cell


class ProductFlops(TorchDispatchMode):
    """FLOPs of every operator torch's FlopCounterMode counts (matrix
    products and convolutions), without its module hooks (which
    autograd.grad on a leaf does not support)."""

    def __init__(self):
        super().__init__()
        self.by_op = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.by_op[str(packet)] = self.by_op.get(str(packet), 0) + n
        return out


def test_count_is_at_most_what_the_port_executes():
    from benchmark.flops import net_macs, step_flops
    from benchmark.session import Session
    cell = tiny_cell("tight-fine-1080")
    s = Session(cell, 5, tempfile.mkdtemp(), "cpu")
    s.set_up()
    s.one_step()                       # the stage's first step remeshes
    tr = s.trainer
    counter = ProductFlops()
    with counter:
        s.one_step()
    cfg = tr.stage_cfg
    counted = step_flops(net_macs(cell.config), cfg.rays(), cfg.N,
                         tr.tmp.verts.shape[0], cfg.surf_iters, True)
    executed = sum(counter.by_op.values())
    # the difference: the reverse passes through the eikonal, Jacobian and
    # normal terms' own gradient graphs, and the skinning and 3x3 products
    print(f"counted {counted:.4g}, executed {executed:.4g} "
          f"({counter.by_op}); not counted {executed - counted:.4g}")
    assert counted <= executed
    assert counted >= 0.4 * executed


def test_macs_of_the_published_widths():
    from benchmark.cell import load_cell
    from benchmark.flops import net_macs
    from benchmark.reference.step import Nets
    cell = load_cell("tight-fine-1080")
    nets = Nets(cell.config["conf"])
    for name, mod in (("sdf", nets.sdf), ("translator", nets.translator),
                      ("render", nets.netRender)):
        got = sum(p.numel() for n, p in mod.named_parameters()
                  if n.endswith("weight_v") or n.endswith("weight"))
        assert net_macs(cell.config)[name] == got
