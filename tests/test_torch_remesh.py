"""Parity of the port's remesh (octree sweep + marching cubes) and IGR
pretraining with the JAX package at the trainer's test resolutions.

Two SDFs: the geometric-init sphere (radius 0.6), and the same SDF after 20
IGR iterations on the toy body, both sides fed the JAX draws.  Remeshing one
SDF must give the same nv / nf, the same faces, the volume at 1e-5
absolute, and the vertices at 1e-5 absolute for 99.5% of them and 1e-4 for
all: the iso interpolation t = -v0 / (v1 - v0) divides the MLPs' ~5e-7
output difference by the edge's value change, which is ~1e-3 on a few
edges.  The two IGR runs must agree to 1e-4 relative in their
losses and weights; float32 drift through 20 Adam steps then moves the
volume by ~2e-5, enough to flip the sign of a voxel sitting at zero, so
each side's OWN post-IGR mesh is held to nv / nf within 0.1%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.engine.igr_init import igr_pretrain as jigr
from selfreconcode_tpu.engine.trainer import _DEFAULT_TEST_RES
from selfreconcode_tpu.models import sdf as JSDF
from selfreconcode_tpu.models import skinner as JSK
from selfreconcode_tpu.models import smpl as JSMPL
from selfreconcode_tpu.ops import marching_cubes as JMC
from selfreconcode_tpu.ops import sparse_sdf as JSS
from selfreconcode_tpu.utils import meshops as JMO
from selfreconcode_tpu_torch.engine.igr_init import igr_pretrain
from selfreconcode_tpu_torch.interop import params_from_jax, params_to_jax
from selfreconcode_tpu_torch.models.sdf import SDFNet
from selfreconcode_tpu_torch.ops.marching_cubes import marching_cubes
from selfreconcode_tpu_torch.ops.sparse_sdf import (grid_world_coords,
                                                    sparse_sdf_grid)

NET = dict(hidden=(64,) * 4, skip_in=(2,), multires=2)
IGR_ITERS = 20


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def body():
    jsk, vs, fs = JSK.build_skinner(JSMPL.toy_smpl_model(400), jnp.zeros(10),
                                    JSMPL.smpl_tmp_apose(1),
                                    resolution=(17, 29, 9))
    ns = JMO.vertex_normals(vs, jnp.asarray(fs), jnp.ones(fs.shape[0], bool))
    return (np.asarray(jsk.b_min), np.asarray(jsk.b_max), np.asarray(vs),
            np.asarray(ns))


def port_sdf(params_np):
    net = SDFNet(**NET, seed=None)
    sd = params_from_jax({"sdf": params_np, "trans": [], "render": []})
    net.load_state_dict({k[4:]: torch.tensor(v) for k, v in sd.items()})
    return net


def jax_igr_draws(key, n_iters, v):
    """The draws igr_pretrain makes (its key splits, in order)."""
    out = []
    for k in jax.random.split(key, n_iters):
        k1, k2 = jax.random.split(k)
        idx = jax.random.randint(k1, (v,), 0, v)
        ka, kb = jax.random.split(k2)
        out.append((torch.tensor(np.asarray(idx)).long(),
                    torch.tensor(np.asarray(jax.random.normal(ka, (v, 3)))),
                    torch.tensor(np.asarray(
                        jax.random.uniform(kb, (v // 6, 3))))))
    return out


def remesh_both(jnet, jp, tnet, b_min, b_max):
    res = tuple(tuple(r) for r in _DEFAULT_TEST_RES)
    spacing, origin = JSS.grid_world_coords(res[-1], b_min, b_max)
    jvol = JSS.sparse_sdf_grid(
        lambda p: JSDF.sdf_value_only(jp, jnet, p, 1.0), res, b_min, b_max,
        0.0, JSS.default_caps(res))
    jmc = JMC.marching_cubes(jvol, origin, spacing, 0.0, 40000, 80000, 20000)
    assert int(jmc.nv) <= 40000 and int(jmc.na) <= 20000
    with torch.no_grad():
        tvol = sparse_sdf_grid(lambda p: tnet(p, 1.0)[0], res, b_min, b_max,
                               0.0)
        sp, org = grid_world_coords(res[-1], b_min, b_max)
        tmc = marching_cubes(tvol, org, sp, 0.0)
    return jvol, jmc, tvol, tmc


def check_same_mesh(jvol, jmc, tvol, tmc):
    np.testing.assert_allclose(tvol.numpy(), np.asarray(jvol), atol=1e-5)
    nv, nf = int(jmc.nv), int(jmc.nf)
    assert nv > 0
    assert (tmc.verts.shape[0], tmc.faces.shape[0]) == (nv, nf)
    np.testing.assert_array_equal(tmc.faces.numpy(),
                                  np.asarray(jmc.faces)[:nf])
    # JAX leaves the crossings on +boundary edges at (0, 0, 0); the port
    # puts them on their edges, which lie on the sweep box's + faces
    jv, tv = np.asarray(jmc.verts)[:nv], tmc.verts.numpy()
    ownerless = (jv == 0).all(1)
    assert ownerless.sum() == tmc.n_boundary
    on_face = (np.abs(tv[ownerless] - tv.max(0)) <= 1e-5).any(1)
    assert on_face.all()
    err = np.abs(tv - jv).max(1)[~ownerless]
    assert (err <= 1e-5).mean() >= 0.995 and err.max() <= 1e-4, err.max()
    assert tmc.n_boundary == int(jmc.n_boundary)
    np.testing.assert_array_equal(tmc.boundary_sides,
                                  np.asarray(jmc.boundary_sides))


def test_remesh_geometric_init_sphere(body):
    b_min, b_max, _, _ = body
    jnet = JSDF.SDFNet(**NET)
    jp = JSDF.init_sdf_params(jax.random.PRNGKey(0), jnet)
    net = port_sdf(jax.tree_util.tree_map(np.asarray, jp))
    check_same_mesh(*remesh_both(jnet, jp, net, b_min, b_max))


def test_igr_then_remesh_matches(body):
    b_min, b_max, vs, ns = body
    jnet = JSDF.SDFNet(**NET)
    jp0 = JSDF.init_sdf_params(jax.random.PRNGKey(0), jnet)
    net = port_sdf(jax.tree_util.tree_map(np.asarray, jp0))
    key = jax.random.PRNGKey(7)
    jp, jinfo = jigr(key, jp0, jnet, jnp.asarray(vs), jnp.asarray(ns),
                     n_iters=IGR_ITERS)
    info = igr_pretrain(net, torch.tensor(vs), torch.tensor(ns),
                        n_iters=IGR_ITERS,
                        draws=jax_igr_draws(key, IGR_ITERS, vs.shape[0]))
    for k in jinfo:
        np.testing.assert_allclose(info[k], jinfo[k], rtol=1e-4)
    mine = params_to_jax({f"sdf.{k}": v for k, v in net.state_dict().items()})
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(mine["sdf"])):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5)
    _, jmc, _, tmc = remesh_both(jnet, jp, net, b_min, b_max)
    for mine_n, ref_n in ((tmc.verts.shape[0], int(jmc.nv)),
                          (tmc.faces.shape[0], int(jmc.nf))):
        assert abs(mine_n - ref_n) <= 1e-3 * ref_n, (mine_n, ref_n)
    # the JAX post-IGR SDF, carried across, remeshes identically
    same = port_sdf(jax.tree_util.tree_map(np.asarray, jp))
    check_same_mesh(*remesh_both(jnet, jp, same, b_min, b_max))


def test_boundary_crossings_sit_on_their_edges():
    """A sphere that leaves the grid through its + faces: every crossing,
    also those on +boundary edges that no cube owns, lies on its grid edge,
    so no triangle is longer than a cell diagonal (JAX leaves those
    crossings at the origin)."""
    n, h = 17, 0.1
    g = np.arange(n, dtype=np.float32) * h - 1.1           # [-1.1, 0.5]
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    vol = torch.tensor(np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.9)
    mc = marching_cubes(vol, [-1.1] * 3, [h] * 3, 0.0)
    assert mc.n_boundary > 0
    v = mc.verts
    assert not (v == 0).all(1).any()
    assert (v >= -1.1 - 1e-6).all() and (v <= 0.5 + 1e-6).all()
    tri = v[mc.faces]
    edge = torch.linalg.norm(tri - tri.roll(1, dims=1), dim=-1)
    assert float(edge.max()) <= np.sqrt(3) * h + 1e-5
    np.testing.assert_allclose(torch.linalg.norm(v, dim=1).numpy(), 0.9,
                               atol=0.02)
