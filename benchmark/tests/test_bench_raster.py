"""The raster yardstick counts from the algorithm's inputs: it does not
move when the port's raster cells change; and the reference's nearest-face
rasterizer is the port's mesh fragments, tie rule and all where no tie
parts them."""
import pytest
import torch


def square(H=12, W=12):
    """Two faces covering the pixel square [2, 5] x [2, 5] at depth 1 (the
    diagonal's pixels in both), one face behind the camera, one off the
    image."""
    screen = torch.tensor([[2.0, 2.0, 1.0], [5.0, 2.0, 1.0], [5.0, 5.0, 1.0],
                           [2.0, 5.0, 1.0], [1.0, 1.0, -1.0],
                           [30.0, 30.0, 1.0], [40.0, 30.0, 1.0],
                           [30.0, 40.0, 1.0]])
    faces = torch.tensor([[0, 1, 2], [0, 2, 3], [4, 1, 2], [5, 6, 7]])
    return screen, faces, H, W


def test_counts_on_a_known_layout():
    from benchmark.raster_work import frame_work, least_time
    w = frame_work(*square())
    # each face's box is the 4x4 pixels; the lower and the upper triangle
    # each hold 10 of them, the 4 on the diagonal in both
    assert w == {"faces": 2, "box_pairs": 32, "inside_pairs": 20,
                 "covered_px": 16}
    assert least_time(w) > 0


def test_reference_raster_on_a_known_layout():
    from benchmark.reference.raster import nearest_faces
    screen, faces, H, W = square()
    fr = nearest_faces(screen, faces, H, W)
    covered = torch.zeros(H, W, dtype=torch.bool)
    covered[2:6, 2:6] = True
    assert torch.equal(fr.face >= 0, covered)
    # the diagonal ties at z = 1: the lower face id wins
    assert fr.ties == 4 and all(int(fr.face[i, i]) == 0 for i in range(2, 6))
    assert int(fr.face[5, 2]) == 1 and int(fr.face[2, 5]) == 0
    assert torch.allclose(fr.bary.sum(-1)[covered], torch.ones(16))


def mesh(n_faces=600, H=64, W=80, seed=0, dup=False):
    """Random small triangles in front of the camera, some overlapping and
    some crossing the image's edge, as screen vertices."""
    g = torch.Generator().manual_seed(seed)
    c = torch.rand(n_faces, 1, 2, generator=g) * torch.tensor(
        [W + 10.0, H + 10.0]) - 5.0
    xy = c + torch.randn(n_faces, 3, 2, generator=g) * 3.0
    z = torch.rand(n_faces, 3, 1, generator=g) + 1.0
    screen = torch.cat([xy, z], -1).reshape(-1, 3)
    faces = torch.arange(3 * n_faces).reshape(n_faces, 3)
    if dup:
        faces = torch.cat([faces, faces])
    return screen, faces, H, W


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "doubled"])
def test_reference_raster_is_the_port_plain(dup, monkeypatch):
    """Against the port's mesh fragments (on the CPU its plain version,
    which the kernel rounds as): the same faces, depths and barycentrics,
    in blocks of any size.  Doubled faces tie everywhere they cover, in
    the same cells by the same offsets: the lower id wins on both sides."""
    import benchmark.reference.raster as RR
    from selfreconcode_tpu_torch.ops import mesh_kernels as MK
    from selfreconcode_tpu_torch.ops.rasterize import cell_bins
    screen, faces, H, W = mesh(dup=dup)
    tri = screen[faces]
    rec = torch.cat([tri[:, :, :2].reshape(-1, 6), tri[:, :, 2]],
                    1).contiguous()
    xs, ys = tri[:, :, 0], tri[:, :, 1]
    ok = ((tri[:, :, 2] > 0).all(1) & (xs.amax(1) >= 0)
          & (xs.amin(1) <= W - 1) & (ys.amax(1) >= 0) & (ys.amin(1) <= H - 1))
    b = cell_bins(xs.amin(1), ys.amin(1), xs.amax(1), ys.amax(1), ok, H, W, 8)
    zbuf, face, bary = MK.mesh_fragments_plain(rec, b.entries, b.cell_ids,
                                               b.starts, b.counts, b.cs,
                                               b.ncx, H, W)
    monkeypatch.setattr(RR, "BLOCK", 97)
    fr = RR.nearest_faces(screen, faces, H, W)
    assert torch.equal(fr.face, face.long())
    assert torch.equal(fr.zbuf, zbuf) and torch.equal(fr.bary, bary)
    covered = int((face >= 0).sum())
    assert covered > 0
    assert (fr.ties == covered) if dup else (fr.ties < covered // 100 + 1)


@pytest.mark.parametrize("cs", [8, 16, 32])
def test_bound_does_not_read_the_port_cells(cs, monkeypatch):
    from benchmark.raster_work import frame_work, least_time
    from selfreconcode_tpu_torch.ops import rasterize as R
    screen, faces, H, W = mesh()
    before = frame_work(screen, faces, H, W)
    monkeypatch.setattr(R, "mesh_cell_size", lambda fp: cs)
    after = frame_work(screen, faces, H, W)
    assert before == after and least_time(before) == least_time(after)
    assert before["faces"] > 0 and before["covered_px"] > 0
