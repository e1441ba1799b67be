"""Parity of the port's ``rasterize_mesh`` (the mesh kernel's plain version,
which is what a CPU tensor gets) with the JAX ``rasterize_mesh`` (its Pallas
kernel, in interpret mode on the CPU) and with the JAX scatter reference
``rasterize_mesh_scatter``; and of ``phong_shade`` with the JAX one.

Every mesh comes from numpy.  The JAX Pallas path is compared only where its
binning drops nothing (``overflow == 0``, every triangle within 2x2 cells),
since the port has no capacity and bins a wide triangle into every cell it
covers; elsewhere the port is held to the scatter reference.

Tolerances: hit masks identical; z relative 1e-5 on common hits; face ids
equal on >= 99% of common hits, and every disagreement a tie (|dz| <= 1e-5
relative: a pixel on the shared edge of two faces at equal depth, where
float32 rounding picks either); barycentrics absolute 1e-4 where the faces
agree.  Shading absolute 1e-5 on the same fragments; ``render_mesh_phong``
(each side rasterizing for itself) absolute 1e-4 where the face ids agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.ops import binning as JBIN
from selfreconcode_tpu.ops import rasterize as JRA
from selfreconcode_tpu.render import camera as JCAM
from selfreconcode_tpu.render import shading as JSH
from selfreconcode_tpu_torch.ops import mesh_kernels as MK
from selfreconcode_tpu_torch.ops.binning import bbox_cell_entries
from selfreconcode_tpu_torch.ops.rasterize import (Fragments, mesh_bins,
                                                   rasterize_mesh)
from selfreconcode_tpu_torch.render import camera as TCAM
from selfreconcode_tpu_torch.render.shading import (phong_shade,
                                                    render_mesh_phong)

QUAT = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
T = np.array([0.0, 0.0, 2.5], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def uv_sphere(rings, segments=None, radius=0.5, seed=0):
    """Closed UV sphere with a little numpy-seeded jitter on the vertices."""
    segments = segments or 2 * rings
    th = np.linspace(0, np.pi, rings + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)).ravel(),
                     np.cos(th).repeat(segments),
                     np.outer(np.sin(th), np.sin(ph)).ravel()], 1)
    v = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]]) * radius
    v = v + 0.01 * np.random.default_rng(seed).standard_normal(v.shape)
    f = []
    n_in = rings - 1
    for s in range(segments):
        t = (s + 1) % segments
        f.append([0, 1 + t, 1 + s])
        for r in range(n_in - 1):
            a, b = 1 + r * segments, 1 + (r + 1) * segments
            f += [[a + s, a + t, b + s], [a + t, b + t, b + s]]
        last = 1 + (n_in - 1) * segments
        f.append([last + s, last + t, len(v) - 1])
    return v.astype(np.float32), np.asarray(f, np.int32)


def cameras(H, W):
    focal = np.array([0.8 * W, 0.8 * H], np.float32)
    princ = np.array([W / 2 + 0.3, H / 2 - 0.2], np.float32)
    return (JCAM.make_camera(focal, princ, QUAT, T, H, W),
            TCAM.make_camera(focal, princ, QUAT, T, H, W))


def port_frags(tcam, v, f, footprint):
    return rasterize_mesh(tcam, torch.tensor(v), torch.tensor(f).long(),
                          footprint)


def assert_frags_match(mine: Fragments, face, z, bary):
    """mine vs a JAX result (numpy) under the module's tolerances."""
    mf = mine.pix_to_face.numpy()
    np.testing.assert_array_equal(mf >= 0, face >= 0)
    both = (mf >= 0) & (face >= 0)
    assert both.sum() > 100
    mz = mine.zbuf.numpy()
    np.testing.assert_allclose(mz[both], z[both], rtol=1e-5)
    assert np.isinf(mz[~both]).all()
    same = both & (mf == face)
    assert same.sum() >= 0.99 * both.sum(), (same.sum(), both.sum())
    diff = both & (mf != face)
    np.testing.assert_allclose(mz[diff], z[diff], rtol=1e-5)
    np.testing.assert_allclose(mine.bary.numpy()[same], bary[same],
                               atol=1e-4)
    assert (mine.bary.numpy()[~both] == 0).all()


# (rings, image size, footprint, sphere radius): triangles up to ~5 px in
# the 8 px cells, up to ~12 px in the 16 px cells
CASES = {"fp8_cs8": (12, 96, 8, 0.5), "fp12_cs16": (12, 96, 12, 0.7)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_pallas_and_scatter(case):
    rings, hw, footprint, radius = CASES[case]
    v, f = uv_sphere(rings, radius=radius)
    jcam, tcam = cameras(hw, hw)
    fv = jnp.ones(len(f), bool)
    jfr = JRA.rasterize_mesh(jcam, jnp.asarray(v), jnp.asarray(f), fv,
                             footprint)
    assert int(jfr.overflow) == 0, "JAX dropped faces: not comparable"
    mine = port_frags(tcam, v, f, footprint)
    assert_frags_match(mine, np.asarray(jfr.pix_to_face),
                       np.asarray(jfr.zbuf), np.asarray(jfr.bary))
    sfr = JRA.rasterize_mesh_scatter(jcam, jnp.asarray(v), jnp.asarray(f),
                                     fv, 16)
    assert_frags_match(mine, np.asarray(sfr.pix_to_face),
                       np.asarray(sfr.zbuf), np.asarray(sfr.bary))


def test_dense_mesh_drops_nothing():
    """A 24-ring sphere at 64x64 overflows the JAX Pallas cap (128 per
    cell); the port has no cap and still equals the scatter reference."""
    v, f = uv_sphere(24, seed=1)
    jcam, tcam = cameras(64, 64)
    fv = jnp.ones(len(f), bool)
    jfr = JRA.rasterize_mesh(jcam, jnp.asarray(v), jnp.asarray(f), fv, 8)
    assert int(jfr.overflow) > 0
    sfr = JRA.rasterize_mesh_scatter(jcam, jnp.asarray(v), jnp.asarray(f),
                                     fv, 16)
    assert_frags_match(port_frags(tcam, v, f, 8),
                       np.asarray(sfr.pix_to_face), np.asarray(sfr.zbuf),
                       np.asarray(sfr.bary))


def test_wide_faces_are_binned_to_every_cell():
    """Triangles of up to ~30 px at footprint 8 (8 px cells): JAX's Pallas
    binning keeps 2x2 cells of each and leaves holes; the port bins every
    covered cell and equals the scatter reference, which has no cells."""
    v, f = uv_sphere(4, radius=0.7)
    jcam, tcam = cameras(96, 96)
    fv = jnp.ones(len(f), bool)
    sfr = JRA.rasterize_mesh_scatter(jcam, jnp.asarray(v), jnp.asarray(f),
                                     fv, 48)
    mine = port_frags(tcam, v, f, 8)
    assert_frags_match(mine, np.asarray(sfr.pix_to_face),
                       np.asarray(sfr.zbuf), np.asarray(sfr.bary))
    jfr = JRA.rasterize_mesh(jcam, jnp.asarray(v), jnp.asarray(f), fv, 8)
    assert (np.asarray(jfr.pix_to_face) >= 0).sum() < (
        mine.pix_to_face >= 0).sum()
    with pytest.raises(ValueError, match="at most 32"):
        port_frags(tcam, v, f, 40)


def test_binning_matches_jax_entries():
    """Boxes of at most one cell get JAX's (cell, entry id) pairs; a wider
    box gets every cell it covers."""
    rng = np.random.default_rng(4)
    n, cs, ncx, ncy = 300, 8, 5, 4
    lo = rng.uniform(-6, 42, (n, 2)).astype(np.float32)
    hi = lo + rng.uniform(0, cs, (n, 2)).astype(np.float32)
    ok = rng.random(n) > 0.1
    jc, jv, _ = JBIN.bbox_cell_entries(*(jnp.asarray(a) for a in (
        lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], ok)), cs, ncx, ncy)
    jv = np.asarray(jv)
    jpairs = sorted(zip(np.asarray(jc)[jv], np.nonzero(jv)[0]))
    tc, te = bbox_cell_entries(*(torch.tensor(a) for a in (
        lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], ok)), cs, ncx, ncy)
    assert sorted(zip(tc.tolist(), te.tolist())) == \
        [(int(c), int(e)) for c, e in jpairs]
    one = [torch.tensor([v], dtype=torch.float32) for v in (3, 1, 30, 12)]
    tc, te = bbox_cell_entries(*one, torch.tensor([True]), cs, ncx, ncy)
    assert sorted(tc.tolist()) == [0, 1, 2, 3, 5, 6, 7, 8]
    assert set(te.tolist()) == {0, 1, 2, 3}


def test_plain_tie_rule_picks_first_in_run_order():
    """Two identical triangles (faces 0 and 1): the cell's run lists face 1
    first, so face 1 wins every pixel, not the lower id."""
    tri = [2.0, 2.0, 12.0, 3.0, 4.0, 13.0, 1.5, 1.5, 1.5]
    rec = torch.tensor([tri, tri], dtype=torch.float32)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    # one 16 px cell (cs 16, ncx 1); entries 1 (face 1) then 0 (face 0)
    z, face, bary = MK.mesh_fragments_plain(rec, i32([1, 0]), i32([0]),
                                            i32([0]), i32([2]), 16, 1, 16, 16)
    hit = face >= 0
    assert hit.sum() > 20
    assert (face[hit] == 1).all()
    torch.testing.assert_close(z[hit], torch.full_like(z[hit], 1.5))
    torch.testing.assert_close(bary[hit].sum(-1),
                               torch.ones(int(hit.sum())))
    z2, face2, _ = MK.mesh_fragments_plain(rec, i32([0, 1]), i32([0]),
                                           i32([0]), i32([2]), 16, 1, 16, 16)
    assert (face2[hit] == 0).all()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    v, f = uv_sphere(12)
    _, tcam = cameras(96, 96)
    before = MK.launches.mesh_raster_launches
    mine = port_frags(tcam, v, f, 8)
    assert MK.launches.mesh_raster_launches == before
    assert mine.pix_to_face.dtype == torch.int32
    assert mine.zbuf.shape == (96, 96) and mine.bary.shape == (96, 96, 3)
    with pytest.raises(ValueError):
        MK.mesh_fragments(torch.zeros(4, 8), *(torch.zeros(1, dtype=torch.int32)
                                               for _ in range(4)),
                          8, 1, 8, 8)


def test_empty_and_hidden_meshes_give_the_fill():
    """No face at all, and a mesh wholly behind the camera: no active cell,
    and every pixel keeps the fill (z +inf, face -1, bary 0)."""
    v, f = uv_sphere(12)
    _, tcam = cameras(32, 32)
    for verts, faces in ((v, f[:0]), (v - np.float32([0, 0, 5]), f)):
        _, b = mesh_bins(tcam, torch.tensor(verts), torch.tensor(faces).long(),
                         8)
        assert b.cell_ids.numel() == 0 and b.entries.numel() == 0
        fr = port_frags(tcam, verts, faces, 8)
        assert (fr.pix_to_face == -1).all()
        assert torch.isinf(fr.zbuf).all() and (fr.bary == 0).all()


def test_phong_shade_matches_jax():
    v, f = uv_sphere(12)
    jcam, tcam = cameras(96, 96)
    fv = jnp.ones(len(f), bool)
    jfr = JRA.rasterize_mesh(jcam, jnp.asarray(v), jnp.asarray(f), fv, 8)
    light = np.array([0.3, 1.2, -2.0], np.float32)
    jimg, jhit = JSH.phong_shade(jcam, jnp.asarray(v), jnp.asarray(f), fv,
                                 jfr, jnp.asarray(light))
    frags = Fragments(torch.tensor(np.asarray(jfr.pix_to_face)),
                      torch.tensor(np.asarray(jfr.bary)),
                      torch.tensor(np.asarray(jfr.zbuf)))
    img, hit = phong_shade(tcam, torch.tensor(v), torch.tensor(f).long(),
                           frags, torch.tensor(light))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-5)
    assert (img.numpy()[~hit.numpy()] == 1.0).all()


def test_render_mesh_phong_matches_jax():
    v, f = uv_sphere(12, seed=3)
    jcam, tcam = cameras(96, 96)
    fv = jnp.ones(len(f), bool)
    light = np.array([-0.4, 0.8, -1.5], np.float32)
    jimg, jhit = JSH.render_mesh_phong(jcam, jnp.asarray(v), jnp.asarray(f),
                                       fv, jnp.asarray(light), 8)
    img, hit = render_mesh_phong(tcam, torch.tensor(v), torch.tensor(f).long(),
                                 torch.tensor(light), 8)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    jface = JRA.rasterize_mesh(jcam, jnp.asarray(v), jnp.asarray(f), fv,
                               8).pix_to_face
    agree = port_frags(tcam, v, f, 8).pix_to_face.numpy() == np.asarray(jface)
    assert agree.mean() >= 0.99
    np.testing.assert_allclose(img.numpy()[agree], np.asarray(jimg)[agree],
                               atol=1e-4)


@pytest.mark.cuda
def test_mesh_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs in chip_smoke.py on the card)")
    v, f = uv_sphere(24, seed=2)
    _, tcam = cameras(96, 96)
    cam = TCAM.Camera(*(getattr(tcam, k).cuda() for k in
                        ("focal", "principal", "R", "T")), 96, 96)
    rec, b = mesh_bins(cam, torch.tensor(v, device="cuda"),
                       torch.tensor(f, device="cuda"), 8)
    args = (rec, b.entries, b.cell_ids, b.starts, b.counts, b.cs, b.ncx, 96,
            96)
    n0 = MK.launches.mesh_raster_launches
    got = MK.mesh_fragments(*args)
    assert MK.launches.mesh_raster_launches == n0 + 1
    for a, e in zip(got, MK.mesh_fragments_plain(*args)):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    # a mesh behind the camera has no active cell: nothing is launched
    rec0, b0 = mesh_bins(cam, torch.tensor(v - np.float32([0, 0, 5]),
                                           device="cuda"),
                         torch.tensor(f, device="cuda"), 8)
    z0, f0, _ = MK.mesh_fragments(rec0, b0.entries, b0.cell_ids, b0.starts,
                                  b0.counts, b0.cs, b0.ncx, 96, 96)
    assert MK.launches.mesh_raster_launches == n0 + 1
    assert (f0 == -1).all() and torch.isinf(z0).all()
