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
from selfreconcode_tpu_torch.ops.rasterize import (Fragments, cell_bins,
                                                   mesh_bins, rasterize_mesh)
from selfreconcode_tpu_torch.render import camera as TCAM
from selfreconcode_tpu_torch.utils import trace
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


def launches():
    """Mesh-kernel launches counted since the last read (which clears)."""
    return trace.read_and_clear()["counters"].get("mesh_raster_launches", 0)


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


def keyed_fragments(rec, entries, cell_ids, starts, counts, cs, ncx, H, W):
    """The mesh kernel's algorithm in torch: every entry tests only the
    pixels of its ``pixel_box`` in its cell and the image with
    ``inside_by_signs``, each inside pair offers ``pack_key(z, run
    position)``, a pixel keeps the least key, and the winner's
    barycentrics are recomputed from its record."""
    F, P = rec.shape[0], cs * cs
    k = torch.arange(P)
    cell = torch.repeat_interleave(cell_ids.long(), counts.long())
    px = (cell % ncx * cs)[:, None] + k % cs
    py = (cell // ncx * cs)[:, None] + k // cs
    r = rec[entries.long() % F]
    x_lo, x_hi, y_lo, y_hi = (t[:, None] for t in MK.pixel_box(r))
    X, Y = px.float(), py.float()
    box = ((X >= x_lo) & (X <= x_hi) & (Y >= y_lo) & (Y <= y_hi)
           & (px < W) & (py < H))
    ax, ay, bx, by, cx, cy = (r[:, None, j] for j in range(6))
    inside = MK.inside_by_signs(
        (bx - ax) * (cy - ay) - (by - ay) * (cx - ax),
        (cx - bx) * (Y - by) - (cy - by) * (X - bx),
        (ax - cx) * (Y - cy) - (ay - cy) * (X - cx),
        (bx - ax) * (Y - ay) - (by - ay) * (X - ax))
    b0, b1, b2, _ = MK.edge_bary(r[:, None, :], X, Y)
    z = 1.0 / (b0 / r[:, None, 6] + b1 / r[:, None, 7]
               + b2 / r[:, None, 8]).clamp_min(1e-12)
    take = box & inside & (z < float("inf"))
    pos = torch.arange(entries.shape[0])[:, None].expand(-1, P)
    key = torch.full((H * W,), MK.KEY_EMPTY, dtype=torch.int64)
    key.scatter_reduce_(0, (py * W + px)[take],
                        MK.pack_key(z[take], pos[take]), "amin")
    hit = torch.nonzero(key < MK.KEY_EMPTY).squeeze(1)
    zw, win = MK.unpack_key(key[hit])
    f = entries[win].long() % F
    rw = rec[f]
    c0, c1, c2, _ = MK.edge_bary(rw, (hit % W).float(), (hit // W).float())
    t = torch.stack([c0 / rw[:, 6], c1 / rw[:, 7], c2 / rw[:, 8]], dim=1)
    ts = (t[:, 0] + t[:, 1] + t[:, 2]).clamp_min(1e-12)
    zbuf = torch.full((H * W,), float("inf"))
    face = torch.full((H * W,), -1, dtype=torch.int32)
    bary = torch.zeros((H * W, 3))
    zbuf[hit], face[hit], bary[hit] = zw, f.to(torch.int32), t / ts[:, None]
    return zbuf.reshape(H, W), face.reshape(H, W), bary.reshape(H, W, 3)


def assert_bits_equal(got, want):
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and a.shape == e.shape
        assert torch.equal(a.contiguous().view(torch.int32),
                           e.contiguous().view(torch.int32))


def test_plain_tie_rule_picks_first_in_run_order():
    """Two identical triangles (faces 0 and 1): the cell's run lists face 1
    first, so face 1 wins every pixel, not the lower id.  The kernel's
    (z bits, run position) key gives the same winner and the same bits in
    both run orders."""
    tri = [2.0, 2.0, 12.0, 3.0, 4.0, 13.0, 1.5, 1.5, 1.5]
    rec = torch.tensor([tri, tri], dtype=torch.float32)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    # one 16 px cell (cs 16, ncx 1); entries 1 (face 1) then 0 (face 0)
    args = (i32([0]), i32([0]), i32([2]), 16, 1, 16, 16)
    z, face, bary = MK.mesh_fragments_plain(rec, i32([1, 0]), *args)
    hit = face >= 0
    assert hit.sum() > 20
    assert (face[hit] == 1).all()
    torch.testing.assert_close(z[hit], torch.full_like(z[hit], 1.5))
    torch.testing.assert_close(bary[hit].sum(-1),
                               torch.ones(int(hit.sum())))
    assert_bits_equal(keyed_fragments(rec, i32([1, 0]), *args),
                      (z, face, bary))
    z2, face2, bary2 = MK.mesh_fragments_plain(rec, i32([0, 1]), *args)
    assert (face2[hit] == 0).all()
    assert_bits_equal(keyed_fragments(rec, i32([0, 1]), *args),
                      (z2, face2, bary2))


def test_key_order_is_depth_then_run_position():
    """pack_key orders as (z, position) lexicographically for positive
    finite z (1 / max(inv_z, 1e-12) lies in (0, 1e12]), round-trips, and
    stays below KEY_EMPTY."""
    rng = np.random.default_rng(5)
    z = torch.tensor(np.concatenate([
        10.0 ** rng.uniform(-3, 12, 500), [1e12, 1.5, 1.5, 1e-30]]),
        dtype=torch.float32)
    pos = torch.tensor(rng.integers(0, 2 ** 31 - 1, z.shape[0]))
    key = MK.pack_key(z, pos)
    assert bool((key < MK.KEY_EMPTY).all())
    zu, pu = MK.unpack_key(key)
    assert torch.equal(zu, z) and torch.equal(pu, pos)
    i, j = torch.meshgrid(torch.arange(z.shape[0]), torch.arange(z.shape[0]),
                          indexing="ij")
    lex = (z[i] < z[j]) | ((z[i] == z[j]) & (pos[i] < pos[j]))
    assert torch.equal(key[i] < key[j], lex)


def test_inside_by_signs_is_edge_bary_inside():
    """The kernel's divide-free inside test equals ``edge_bary``'s on edge
    values from 1e-45 to 1e38 of either sign, zeros, infinities and NaN,
    and areas around the 1e-12 cut, subnormal-quotient ones and
    non-finite ones."""
    rng = np.random.default_rng(11)
    n = 200_000
    def vals(lo, hi):
        v = rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(lo, hi, n)
        special = rng.random(n) < 0.05
        v[special] = rng.choice([0.0, -0.0, np.inf, -np.inf, np.nan,
                                 1e-45, -1e-45], int(special.sum()))
        return torch.tensor(v.astype(np.float32))
    area = vals(-14, 38)
    area[:1000] = torch.tensor(rng.choice([1e-12, -1e-12, 1.0000001e-12,
                                           np.inf, -np.inf, np.nan, 0.0],
                                          1000).astype(np.float32))
    w = [vals(-45, 38) for _ in range(3)]
    # edges that make |w / area| straddle 2^-150 (the quotient's underflow)
    q = 2.0 ** -150 * rng.choice([0.5, 1.0, 1.0000001, 1.5, 2.0], n)
    w[1] = torch.where(torch.rand(n) < 0.5, -area * torch.tensor(
        q.astype(np.float32)), w[1])
    ok = area.abs() > 1e-12
    d = torch.where(ok, area, torch.ones_like(area))
    want = ok & (w[0] / d >= 0) & (w[1] / d >= 0) & (w[2] / d >= 0)
    got = MK.inside_by_signs(area, *w)
    assert torch.equal(got, want)
    assert 0.05 < float(want.float().mean()) < 0.5


def adversarial_triangles(kind, n, S, rng):
    """(n, 3, 2) float32 screen triangles inside an S x S image."""
    if kind == "random":
        v = rng.uniform(10, S - 10, (n, 1, 2)) + rng.normal(0, 2, (n, 3, 2))
    elif kind == "wide60":
        v = rng.uniform(40, S - 40, (n, 1, 2)) + rng.uniform(-30, 30,
                                                             (n, 3, 2))
    elif kind == "on_pixel":
        v = rng.integers(30, S - 30, (n, 1, 2)) + rng.integers(-20, 21,
                                                               (n, 3, 2))
    elif kind == "sliver":
        # a thin triangle along a lattice direction from a pixel centre,
        # its third vertex off the line by 0-1e-2 px
        a = rng.integers(20, S - 60, (n, 1, 2)).astype(np.float64)
        d = (rng.choice([[1, 1], [1, 0], [0, 1], [1, -1], [2, 1], [3, 1]],
                        n)[:, None, :] * rng.integers(1, 20, (n, 1, 1)))
        off = (rng.choice([0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2], (n, 1, 1))
               * rng.normal(size=(n, 1, 2)))
        v = np.concatenate(
            [a, a + d, a + d * rng.uniform(0.3, 1.2, (n, 1, 1)) + off], 1)
    else:                                   # zero_area: collinear
        a = rng.uniform(10, S - 10, (n, 1, 2))
        d = rng.uniform(-20, 20, (n, 1, 2))
        v = np.concatenate([a, a + d, a + 0.5 * d], 1)
    return v.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "sliver", "zero_area", "wide60",
                                  "on_pixel"])
def test_pixel_box_holds_every_inside_pixel(kind):
    """Every (face, pixel) pair that the plain version's edge test puts
    inside lies in the face's pixel box, over the whole image.  The sliver
    family has pairs inside but outside the bbox widened by 1e-3 px: the
    fixed margin the splat kernels use would drop them."""
    S = 160
    v = torch.tensor(adversarial_triangles(kind, 300, S,
                                           np.random.default_rng(7)))
    rec = torch.cat([v.reshape(-1, 6), torch.ones(v.shape[0], 3)], 1)
    X = torch.arange(S, dtype=torch.float32)
    Xg, Yg = X[None, :].expand(S, S), X[:, None].expand(S, S)
    inside = MK.edge_bary(rec[:, None, None, :], Xg, Yg)[3]
    x_lo, x_hi, y_lo, y_hi = (t[:, None, None] for t in MK.pixel_box(rec))
    box = (Xg >= x_lo) & (Xg <= x_hi) & (Yg >= y_lo) & (Yg <= y_hi)
    assert not bool((inside & ~box).any())
    bb = [f(v[..., c], 1)[:, None, None] for c in (0, 1)
          for f in (torch.amin, torch.amax)]
    near = ((Xg >= bb[0] - 1e-3) & (Xg <= bb[1] + 1e-3)
            & (Yg >= bb[2] - 1e-3) & (Yg <= bb[3] + 1e-3))
    if kind == "zero_area":
        assert not bool(inside.any())
    else:
        assert int(inside.sum()) > 100
    if kind == "sliver":
        assert bool((inside & ~near).any())
    if kind in ("random", "wide60"):
        # an ordinary face's box is its bbox and one pixel at most beyond
        assert torch.isfinite(x_lo).all()
        assert bool((x_lo >= torch.floor(bb[0]) - 1).all())


@pytest.mark.parametrize("dup", [False, True])
def test_keyed_walk_matches_plain_bit_for_bit(dup):
    """The kernel's algorithm (box walk, key min) equals the plain version
    bit for bit on a sphere with 16 px cells plus slivers and 60 px faces,
    and on the same faces twice over, where every hit is an exact tie that
    the first copy wins."""
    v, f = uv_sphere(24, seed=2)
    _, tcam = cameras(96, 96)
    faces = torch.tensor(f).long()
    rec, b = mesh_bins(tcam, torch.tensor(v), faces, 16)
    extra = adversarial_triangles("sliver", 40, 96, np.random.default_rng(9))
    wide = adversarial_triangles("wide60", 4, 96, np.random.default_rng(10))
    tri = torch.tensor(np.concatenate([extra, wide]).reshape(-1, 6))
    rec = torch.cat([rec, torch.cat([tri, torch.full((tri.shape[0], 3), 2.4)
                                     ], 1)])
    if dup:
        rec = torch.cat([rec, rec])
    F = rec.shape[0]
    xs, ys = rec[:, 0:6:2], rec[:, 1:6:2]
    b = cell_bins(xs.amin(1), ys.amin(1), xs.amax(1), ys.amax(1),
                  torch.ones(F, dtype=torch.bool), 96, 96, 16)
    args = (rec, b.entries, b.cell_ids, b.starts, b.counts, b.cs, b.ncx, 96,
            96)
    want = MK.mesh_fragments_plain(*args)
    assert int((want[1] >= 0).sum()) > 1000
    assert_bits_equal(keyed_fragments(*args), want)
    if dup:
        assert int(want[1].max()) < F // 2


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    v, f = uv_sphere(12)
    _, tcam = cameras(96, 96)
    trace.read_and_clear()
    mine = port_frags(tcam, v, f, 8)
    assert launches() == 0
    assert mine.pix_to_face.dtype == torch.int32
    assert mine.zbuf.shape == (96, 96) and mine.bary.shape == (96, 96, 3)
    with pytest.raises(ValueError):
        MK.mesh_fragments(torch.zeros(4, 8), *(torch.zeros(1, dtype=torch.int32)
                                               for _ in range(4)),
                          8, 1, 8, 8)


def test_images_beyond_the_box_slack_are_refused():
    """The pixel box's 1e-3 px slack covers its own rounding only below
    MAX_SIDE px a side; a larger image raises before any work."""
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    rec = torch.zeros(1, 9)
    side = MK.MAX_SIDE + 1
    with pytest.raises(ValueError, match="px a side"):
        MK.mesh_fragments(rec, i32([0]), i32([0]), i32([0]), i32([1]), 8, 1,
                          side, 8)


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
    trace.read_and_clear()
    got = MK.mesh_fragments(*args)
    assert launches() == 1
    for a, e in zip(got, MK.mesh_fragments_plain(*args)):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    # the faces twice over: every hit an exact tie, won by the first copy,
    # with the same bits on a second launch
    f2 = torch.tensor(np.concatenate([f, f]), device="cuda")
    rec2, b2 = mesh_bins(cam, torch.tensor(v, device="cuda"), f2, 8)
    args2 = (rec2, b2.entries, b2.cell_ids, b2.starts, b2.counts, b2.cs,
             b2.ncx, 96, 96)
    got2 = MK.mesh_fragments(*args2)
    for a, e in zip(got2, MK.mesh_fragments_plain(*args2)):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    for a, e in zip(got2, MK.mesh_fragments(*args2)):
        assert torch.equal(a, e)
    assert int(got2[1].max()) < len(f)
    assert launches() == 2
    # a mesh behind the camera has no active cell: nothing is launched
    rec0, b0 = mesh_bins(cam, torch.tensor(v - np.float32([0, 0, 5]),
                                           device="cuda"),
                         torch.tensor(f, device="cuda"), 8)
    z0, f0, _ = MK.mesh_fragments(rec0, b0.entries, b0.cell_ids, b0.starts,
                                  b0.counts, b0.cs, b0.ncx, 96, 96)
    assert launches() == 0
    assert (f0 == -1).all() and torch.isinf(z0).all()
