"""The splat yardstick counts from the algorithm's inputs: it does not move
when the port's raster cells change, and the reference's dense splat is
the port's mask."""
import pytest
import torch


def scene(n=4000, H=96, W=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    col = torch.rand(n, generator=g) * (W + 8) - 4
    row = torch.rand(n, generator=g) * (H + 8) - 4
    z = torch.rand(n, generator=g) + 0.5
    return col, row, z


@pytest.mark.parametrize("cs", [8, 16, 32])
def test_bound_does_not_read_the_port_cells(cs, monkeypatch):
    from benchmark.splat_work import frame_work, least_time
    from selfreconcode_tpu_torch.ops import rasterize as R
    col, row, z = scene()
    r = 3.24
    before = frame_work(col, row, z, r, 96, 96)
    bins = R.splat_bins(col, row, z, torch.ones_like(z, dtype=torch.bool), r,
                        96, 96, cs)
    monkeypatch.setattr(R, "splat_cell_size", lambda r_pix, fp: cs)
    after = frame_work(col, row, z, r, 96, 96)
    assert before == after and least_time(before) == least_time(after)
    assert bins.cs == cs and before["points"] > 0


def test_counts_on_a_known_layout():
    from benchmark.splat_work import frame_work
    # one splat on a pixel centre, r = 1.5: a 3x3 box, and the 5 pixels with
    # d^2 < 2.25 (centre and its 4 neighbours; the diagonals have d^2 = 2)
    w = frame_work(torch.tensor([10.0]), torch.tensor([10.0]),
                   torch.tensor([1.0]), 1.5, 32, 32)
    assert w == {"points": 1, "box_pairs": 9, "fwd_hits": 9, "bwd_hits": 8,
                 "covered_px": 9}


def test_reference_splat_is_the_port_mask():
    from benchmark.reference.camera import make_camera as ref_camera
    from benchmark.reference.splat import splat_mask as ref_splat
    from selfreconcode_tpu_torch.ops.rasterize import splat_mask
    from selfreconcode_tpu_torch.render.camera import make_camera
    g = torch.Generator().manual_seed(1)
    pts = torch.randn(3000, 3, generator=g) * 0.3 + torch.tensor([0, 0, 2.5])
    pts.requires_grad_(True)
    args = ([96.0, 96.0], [48.0, 48.0], [1.0, 0, 0, 0], [0.0, 0.0, 0.0],
            96, 96)
    valid = torch.ones(3000, dtype=torch.bool)
    m = splat_mask(make_camera(*args), pts, valid, 0.06)
    (gp,) = torch.autograd.grad((m * torch.linspace(0, 1, 96 * 96)
                                 .reshape(96, 96)).sum(), pts)
    mr = ref_splat(ref_camera(*args), pts, 0.06)
    (gr,) = torch.autograd.grad((mr * torch.linspace(0, 1, 96 * 96)
                                 .reshape(96, 96)).sum(), pts)
    assert (m - mr).abs().max() < 1e-5
    assert (gp - gr).abs().max() <= 1e-4 * gr.abs().max()
