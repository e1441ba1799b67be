"""JAX <-> port state conversion, and the port's independence from JAX.

Round trips are exact (numpy copies, no arithmetic).
"""
import os
import re

import jax
import numpy as np
import pytest
import torch

from selfreconcode_tpu.data.dataset import SceneDataset, make_synthetic_scene
from selfreconcode_tpu.engine import trainer as JTR
from selfreconcode_tpu.models import render as JR
from selfreconcode_tpu.models import sdf as JSDF
from selfreconcode_tpu.models import translator as JT
from selfreconcode_tpu_torch import interop
from selfreconcode_tpu_torch.engine.trainer import AvatarNets
from selfreconcode_tpu_torch.models.render import RenderNet
from selfreconcode_tpu_torch.models.sdf import SDFNet
from selfreconcode_tpu_torch.models.translator import TranslatorNet

PKG = os.path.join(os.path.dirname(__file__), "..", "selfreconcode_tpu_torch")


@pytest.fixture(scope="module")
def jax_params():
    nets = (JSDF.SDFNet(hidden=(32,) * 4, skip_in=(2,), multires=2,
                        feature_size=8),
            JT.TranslatorNet(cond_size=4, multires=2, hidden=(32, 32)),
            JR.RenderNet(feature_size=8, hidden=(32,), multires_v=2))
    p = {"sdf": JSDF.init_sdf_params(jax.random.PRNGKey(0), nets[0]),
         "trans": JT.init_translator_params(jax.random.PRNGKey(1), nets[1]),
         "render": JR.init_render_params(jax.random.PRNGKey(2), nets[2])}
    return jax.tree_util.tree_map(np.asarray, p)


def test_params_round_trip_and_reference_key_names(jax_params):
    sd = interop.params_from_jax(jax_params)
    names = set(sd)
    assert "sdf.lin0.weight_v" in names and "sdf.lin0.weight_g" in names
    assert "deformer.defs.0.lin2.weight" in names
    assert "netRender.lin1.bias" in names
    assert sd["sdf.lin0.weight_g"].shape == (32, 1)  # weight_norm layout
    back = interop.params_to_jax(sd)
    for a, b in zip(jax.tree_util.tree_leaves(jax_params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_state_dict_loads_into_port_modules(jax_params):
    nets = AvatarNets(SDFNet(hidden=(32,) * 4, skip_in=(2,), multires=2,
                             feature_size=8, seed=None),
                      TranslatorNet(cond_size=4, multires=2, hidden=(32, 32),
                                    seed=None),
                      RenderNet(feature_size=8, hidden=(32,), multires_v=2,
                                seed=None))
    sd = interop.params_from_jax(jax_params)
    assert set(sd) == set(nets.state_dict())
    nets.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    back = interop.params_to_jax(nets.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(jax_params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_bank_and_template_round_trip(tmp_path):
    make_synthetic_scene(str(tmp_path / "s"), n_frames=3, H=16, W=16)
    ds = SceneDataset(str(tmp_path / "s"),
                      conds_lens={"deformer": 4, "renderer": 6},
                      use_native=False)
    bank = ds.param_bank()
    flat = interop.bank_from_jax(bank)
    assert {"poses", "trans", "dcond", "rcond", "focal_length",
            "princeple_points", "cam2world_coord_quat",
            "world2cam_coord_trans"} == set(flat)
    back = interop.bank_to_jax(flat)
    for a, b in zip(jax.tree_util.tree_leaves(bank),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(bank) == \
        jax.tree_util.tree_structure(back)

    rng = np.random.default_rng(0)
    tmp = JTR.TemplateState(
        verts=rng.normal(size=(8, 3)).astype(np.float32),
        vert_valid=np.arange(8) < 5, faces=rng.integers(0, 5, (6, 3)),
        face_valid=np.arange(6) < 4, edges=None, edge_valid=None,
        edge_faces=None, ef_valid=None,
        momentum=rng.normal(size=(8, 3)).astype(np.float32))
    t = interop.template_from_jax(tmp._asdict())
    np.testing.assert_array_equal(t["verts"], tmp.verts[:5])
    np.testing.assert_array_equal(t["faces"], tmp.faces[:4])
    np.testing.assert_array_equal(t["momentum"], tmp.momentum[:5])


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)


@pytest.mark.parametrize("pattern", [r"^\s*import jax", r"^\s*from jax",
                                     r"optax", r"selfreconcode_tpu\.",
                                     r"^\s*(from|import) tools\b"])
def test_port_never_imports_jax_or_the_jax_package(pattern):
    """Nor the repository's root tools/ (the port keeps its own copies)."""
    hits = []
    for path in _sources():
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                if re.search(pattern, line):
                    hits.append(f"{os.path.relpath(path, PKG)}:{n}: {line}")
    assert not hits, "".join(hits)
