"""The preprocessing CLIs of the port (``cli/generate_boxs.py``,
``cli/generate_normals.py``, ``cli/people_snapshot.py``) against the JAX
package's on the JAX tests' synthetic inputs: an h5 subject with an mp4
written in the test, and a TorchScript normal net scripted in the test.
Each pair runs on its own copy of the inputs; every file either writes must
be byte-identical (on the CPU: the normal net runs with --device cpu).
"""
import os
import os.path as osp
import shutil

import pytest
import torch

from selfreconcode_tpu.cli import generate_boxs as JBOX
from selfreconcode_tpu.cli import generate_normals as JNRM
from selfreconcode_tpu.cli import people_snapshot as JPS
from selfreconcode_tpu_torch.cli import generate_boxs as TBOX
from selfreconcode_tpu_torch.cli import generate_normals as TNRM
from selfreconcode_tpu_torch.cli import people_snapshot as TPS
from test_generate_boxs import _scene as boxs_scene
from test_generate_normals import _scene as normals_scene
from test_people_snapshot import _subject


def tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = osp.join(d, f)
            with open(p, "rb") as fh:
                out[osp.relpath(p, root)] = fh.read()
    return out


def twin(root):
    """A second copy of the input tree beside it."""
    other = str(root) + "_port"
    shutil.copytree(root, other)
    return str(root), other


def test_generate_boxs_matches_jax(tmp_path):
    """jpg frames with zero-padded names (the JAX boxes test's scene) and
    png frames with plain ones (the normals test's)."""
    a, b = twin(boxs_scene(tmp_path / "jpg")[0])
    c, d = twin(normals_scene(tmp_path / "png")[0])
    for j, t in ((a, b), (c, d)):
        before = set(tree(j))
        JBOX.main(["--root", j, "--pad", "0.15"])
        TBOX.main(["--root", t, "--pad", "0.15"])
        got, want = tree(t), tree(j)
        assert set(want) - before       # the rect files were written
        assert got == want


class ConvNormal(torch.nn.Module):
    """A netF stand-in with fixed random weights: a 3x3 conv and tanh, so
    every output pixel depends on its neighbourhood."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.conv = torch.nn.Conv2d(3, 3, 3, padding=1)
        with torch.no_grad():
            self.conv.weight.copy_(torch.randn(3, 3, 3, 3, generator=g) * 0.3)
            self.conv.bias.copy_(torch.randn(3, generator=g) * 0.1)

    def forward(self, x):
        return torch.tanh(self.conv(x))


def test_generate_normals_matches_jax(tmp_path):
    root, _ = normals_scene(tmp_path)
    JBOX.main(["--root", root])
    net = str(tmp_path / "netF.pt")
    torch.jit.script(ConvNormal()).save(net)
    j, t = twin(root)
    JNRM.main(["--root", j, "--net", net])
    TNRM.main(["--root", t, "--net", net, "--device", "cpu"])
    want = tree(osp.join(j, "normals"))
    assert len(want) == 2
    assert tree(osp.join(t, "normals")) == want


def test_generate_normals_refusals(tmp_path):
    """A missing net exits with JAX's instructions; --device cuda without a
    card raises instead of running on the CPU."""
    root, _ = normals_scene(tmp_path)
    with pytest.raises(SystemExit) as e:
        TNRM.main(["--root", root, "--device", "cpu"])
    assert "PIFuHD's netF as TorchScript" in str(e.value)
    if not torch.cuda.is_available():
        net = str(tmp_path / "netF.pt")
        torch.jit.script(ConvNormal()).save(net)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TNRM.main(["--root", root, "--net", net])


@pytest.mark.parametrize("sid", [0, 1])
def test_people_snapshot_matches_jax(tmp_path, sid):
    root, _, _ = _subject(tmp_path)
    j, t = str(tmp_path / "scene_jax"), str(tmp_path / "scene_port")
    JPS.main(["--root", str(root), "--save_root", j, "--sid", str(sid)])
    TPS.main(["--root", str(root), "--save_root", t, "--sid", str(sid)])
    want = tree(j)
    assert len(want) == 2 * (4 - sid) + 2
    assert tree(t) == want


def test_people_snapshot_refuses_an_unknown_gender(tmp_path):
    root, _, _ = _subject(tmp_path)
    other = tmp_path / "subject-9"
    shutil.copytree(root, other)
    with pytest.raises(SystemExit, match="cannot infer gender"):
        TPS.main(["--root", str(other), "--save_root",
                  str(tmp_path / "out")])
