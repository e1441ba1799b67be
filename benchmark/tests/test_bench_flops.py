"""step_mfu's FLOP count is of the algorithm and a lower bound of what the
port executes: on a tiny step (the published widths) it is at most the
matrix-product FLOPs the port runs, by torch's own FLOP formulas, with the
solver and the anchor the configuration names; and for the cells' own
algorithm it is what it was before the configuration could name them."""
import tempfile

import pytest

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


@pytest.mark.parametrize("keys", [
    {}, {"surf_newton": False}, {"anchor_sub": 0}, {"anchor_sub": 256},
    {"point_inits": False, "surf_newton": False, "anchor_sub": 0}],
    ids=["default", "cauchy", "full_anchor", "anchor_256", "published"])
def test_count_is_at_most_what_the_port_executes(keys):
    """The configuration's keys set in the count and in the port alike
    (anchor_256: at this size 16384 and 0 both anchor every vertex)."""
    from benchmark.flops import net_macs, step_flops
    from benchmark.reference.step import SURF_ITERS, step_algorithm
    from benchmark.session import Session
    cell = tiny_cell("tight-fine-1080")
    cell.config["conf"]["train"].update(keys)
    alg = step_algorithm(cell.config["conf"])
    s = Session(cell, 5, tempfile.mkdtemp(), "cpu")
    s.set_up()
    s.trainer.override_stage(**keys)
    s.one_step()                       # the stage's first step remeshes
    tr = s.trainer
    counter = ProductFlops()
    with counter:
        s.one_step()
    cfg = tr.stage_cfg
    counted = step_flops(net_macs(cell.config), cfg.rays(), cfg.N,
                         tr.tmp.verts.shape[0], SURF_ITERS, True,
                         newton=alg["surf_newton"],
                         anchor_sub=alg["anchor_sub"])
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


# step_flops of the three cells' algorithm (Newton, 16384 anchor vertices,
# the deformation term on) at 6144 rays, before the configuration named the
# solver and the anchor: (frames, template vertices, normal loss) -> FLOPs
PINNED = {
    (1, 3000, True): 1564545404928.0, (1, 3000, False): 1553812180992.0,
    (1, 61234, True): 2110981355520.0, (1, 61234, False): 2100248131584.0,
    (1, 121626, True): 2532987123712.0, (1, 121626, False): 2522253899776.0,
    (3, 3000, True): 1925953179648.0, (3, 3000, False): 1915219955712.0,
    (3, 61234, True): 3324534437888.0, (3, 61234, False): 3313801213952.0,
    (3, 121626, True): 4590551742464.0, (3, 121626, False): 4579818518528.0}


@pytest.mark.parametrize("cell", ["tight-fine-1080", "loose-fine-1080",
                                  "tight-coarse-1080"])
def test_cells_count_is_pinned(cell):
    """The cells' configurations name no solver or anchor: their count,
    read through the keys' defaults as step_mfu reads it, is unchanged."""
    from benchmark.cell import load_cell
    from benchmark.flops import net_macs, step_flops
    from benchmark.reference.step import step_algorithm
    c = load_cell(cell)
    alg = step_algorithm(c.config["conf"])
    assert (alg["surf_newton"], alg["anchor_sub"]) == (True, 16384)
    n = int(c.config["conf"]["train"][c.traffic["stage"]]["point_render"][
        "batch_size"])
    for (frames, nv, normal), want in PINNED.items():
        if frames != n:
            continue
        assert step_flops(net_macs(c.config), 6144, n, nv, 10, normal, True,
                          alg["surf_newton"], alg["anchor_sub"]) == want
        assert step_flops(net_macs(c.config), 6144, n, nv, 10, normal) == want


def test_cauchy_and_full_anchor_counts():
    """What the published branches add or take, by the module's terms."""
    from benchmark.cell import load_cell
    from benchmark.flops import net_macs, step_flops
    macs = net_macs(load_cell("tight-fine-1080").config)
    S, T = 2.0 * macs["sdf"], 2.0 * macs["translator"]
    base = step_flops(macs, 6144, 1, 121626, 10, True)
    full = step_flops(macs, 6144, 1, 121626, 10, True, anchor_sub=0)
    assert full - base == 2 * S * (121626 - 16384)
    assert step_flops(macs, 6144, 1, 9000, 10, True, anchor_sub=0) == \
        step_flops(macs, 6144, 1, 9000, 10, True)
    cauchy = step_flops(macs, 6144, 1, 121626, 10, True, newton=False)
    assert base - cauchy == 6144 * (11 * (2 * S + 4 * T)
                                    - (10 * (2 * S + 2 * T) + 3 * S + 5 * T))
