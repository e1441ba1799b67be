"""The port's edge topology and mesh regularizers against the JAX package's.

Meshes come from numpy: the marching-cubes base mesh of the synthetic body
(closed), a UV sphere with a cap of faces cut away (open: boundary edges),
and that sphere with one extra face on an interior edge (an edge of three
faces, not interior).  The port's exact-size ``build_edge_topology`` must
give the valid rows of both JAX variants (the host one and the device one
over padded faces) exactly.  Losses rtol 1e-5; their vertex gradients rtol
1e-4 (relative to the largest entry: float32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.models import synthetic_body as JSB
from selfreconcode_tpu.utils import meshops as JM
from selfreconcode_tpu_torch.utils import meshops as TM


def uv_sphere(rings=8, segments=12, seed=0):
    th = np.linspace(0, np.pi, rings + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)).ravel(),
                     np.cos(th).repeat(segments),
                     np.outer(np.sin(th), np.sin(ph)).ravel()], 1)
    v = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]]) * 0.5
    v = v + 0.01 * np.random.default_rng(seed).standard_normal(v.shape)
    f = []
    for s in range(segments):
        t = (s + 1) % segments
        f.append([0, 1 + t, 1 + s])
        for r in range(rings - 2):
            a, b = 1 + r * segments, 1 + (r + 1) * segments
            f += [[a + s, a + t, b + s], [a + t, b + t, b + s]]
        last = 1 + (rings - 2) * segments
        f.append([last + s, last + t, len(v) - 1])
    return v.astype(np.float32), np.asarray(f, np.int32)


def mesh(kind):
    if kind == "mc":
        return JSB._mesh_body(JSB._skeleton_joints(), 40)
    v, f = uv_sphere()
    f = f[12:]                          # open: the north cap cut away
    if kind == "three_face_edge":
        a, b = f[40, 0], f[40, 1]
        v = np.concatenate([v, [[0.9, 0.0, 0.0]]]).astype(np.float32)
        f = np.concatenate([f, [[a, b, len(v) - 1]]])
    return v, f


KINDS = ("mc", "open", "three_face_edge")


def _perturbed(v, seed=1):
    rng = np.random.default_rng(seed)
    return (v + 0.003 * rng.standard_normal(v.shape)).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_topology_equals_both_jax_variants(kind):
    v, f = mesh(kind)
    f = np.asarray(f, np.int32)
    topo = TM.build_edge_topology(torch.as_tensor(f))
    E = topo.edges.shape[0]
    edges, pairs = (t.numpy() for t in topo)
    counts = {"open": 0, "three_face_edge": 1, "mc": 0}
    ecap = 3 * len(f) + 64
    host = JM.build_edge_topology(f, len(f), ecap)
    assert host["num_edges"] == E
    pad = np.concatenate([f, np.zeros((37, 3), np.int32)])
    fv = np.arange(len(pad)) < len(f)
    dev = jax.device_get(JM.build_edge_topology_device(
        jnp.asarray(pad), jnp.asarray(fv), ecap))
    assert int(dev["num_edges"]) == E
    for ref in (host, dev):
        assert ref["edge_valid"][:E].all() and not ref["edge_valid"][E:].any()
        np.testing.assert_array_equal(edges, ref["edges"][:E])
        inter = ref["ef_valid"][:E]
        np.testing.assert_array_equal(pairs, ref["edge_faces"][:E][inter])
    n_faces_per_edge = np.bincount(
        np.unique(np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                          f[:, [2, 0]]]), 1), axis=0,
                  return_inverse=True)[1].reshape(-1))
    assert (n_faces_per_edge == 3).sum() == counts[kind]
    assert len(pairs) == (n_faces_per_edge == 2).sum()
    if kind != "mc":
        assert len(pairs) < E


def _jax_losses(v, f, ecap):
    topo = JM.build_edge_topology(f, len(f), ecap)
    vv = jnp.ones(len(v), bool)

    def losses(x):
        return jnp.stack([
            JM.uniform_laplacian_loss(x, topo["edges"], topo["edge_valid"],
                                      vv),
            JM.edge_length_loss(x, topo["edges"], topo["edge_valid"]),
            JM.normal_consistency_loss(x, jnp.asarray(f), topo["edge_faces"],
                                       topo["ef_valid"])])
    vals = losses(jnp.asarray(v))
    grads = [jax.grad(lambda x, i=i: losses(x)[i])(jnp.asarray(v))
             for i in range(3)]
    return np.asarray(vals), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("kind", KINDS)
def test_regularizers_and_gradients_match_jax(kind):
    v, f = mesh(kind)
    v = _perturbed(v)
    f = np.asarray(f, np.int32)
    jvals, jgrads = _jax_losses(v, f, 3 * len(f) + 64)
    faces = torch.as_tensor(f).long()
    topo = TM.build_edge_topology(faces)
    fns = (lambda x: TM.uniform_laplacian_loss(x, topo.edges),
           lambda x: TM.edge_length_loss(x, topo.edges),
           lambda x: TM.normal_consistency_loss(x, faces, topo))
    for i, fn in enumerate(fns):
        x = torch.tensor(v, requires_grad=True)
        val = fn(x)
        val.backward()
        np.testing.assert_allclose(float(val.detach()), jvals[i], rtol=1e-5,
                                   err_msg=str(i))
        g = x.grad.numpy()
        np.testing.assert_allclose(g, jgrads[i], rtol=0,
                                   atol=1e-4 * np.abs(jgrads[i]).max(),
                                   err_msg=str(i))


def test_normal_consistency_without_interior_edges_is_zero_as_in_jax():
    # one triangle: three boundary edges, no pair of faces to compare
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    f = np.array([[0, 1, 2]], np.int32)
    jval = _jax_losses(v, f, 8)[0][2]
    faces = torch.as_tensor(f).long()
    topo = TM.build_edge_topology(faces)
    assert topo.edges.shape == (3, 2) and topo.face_pairs.shape == (0, 2)
    val = TM.normal_consistency_loss(torch.as_tensor(v), faces, topo)
    assert float(val) == float(jval) == 0.0
