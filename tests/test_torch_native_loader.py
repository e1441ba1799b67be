"""The port's native frame loader (``data/native_loader.py`` over its own
``csrc/dataloader.cpp``, built here with g++, libpng and libjpeg) against
cv2 and the JAX package's dataset.

* On a PNG scene with normal maps (one frame without its map), the native
  batch is bitwise the port's cv2 batch, and JAX's
  ``SceneDataset(use_native=False).batch`` (its float images, masks and
  float16 normals) computed from the native bytes is bitwise JAX's own.
* Repeated batches come from the dataset's frame cache.
* An id repeated within one native batch gives the same frame in each
  slot.
* JPEG frames: cv2 bundles its own libjpeg; the measured maximum
  difference to the system libjpeg the loader links is 0 grey levels in
  this environment (the test allows 1: JPEG decoders may round the IDCT
  otherwise).
* A missing toolchain (no compiler on PATH, $CXX naming none, or a
  compiler that finds no png.h / jpeglib.h) selects cv2 with one printed
  line; a source that fails to compile raises; a corrupt frame raises.
"""
import os
import os.path as osp
import shutil

import cv2
import numpy as np
import pytest

from selfreconcode_tpu.data.dataset import SceneDataset as JaxScene
from selfreconcode_tpu_torch.data import native_loader as NL
from selfreconcode_tpu_torch.data.dataset import (SceneDataset,
                                                  make_synthetic_scene)

FIDS = [0, 3, 5, 2]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """6 frames of 40x48 PNGs and RGB normal maps for frames 0-4."""
    root = str(tmp_path_factory.mktemp("nat") / "scene")
    make_synthetic_scene(root, n_frames=6, H=40, W=48)
    os.makedirs(osp.join(root, "normals"))
    rng = np.random.default_rng(0)
    for f in range(5):
        cv2.imwrite(osp.join(root, "normals", f"{f}.png"),
                    rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
    return root


def test_native_batches_match_cv2_and_jax(scene):
    nat = SceneDataset(scene, use_native=True)
    ref = SceneDataset(scene, use_native=False)
    assert (nat.decoder, ref.decoder) == ("native", "cv2")
    for fids in (FIDS, [0, 1, 4]):      # frame 5 has no normal map
        a, b = nat.batch_raw(fids), ref.batch_raw(fids)
        assert a.keys() == b.keys() == ({"img", "mask", "normal"}
                                        if 5 not in fids else
                                        {"img", "mask"})
        for k in a:
            assert a[k].dtype == np.uint8
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jax_ds = JaxScene(scene, conds_lens={}, use_native=False)
    want = jax_ds.batch([0, 1, 4])
    got = nat.batch_raw([0, 1, 4])
    # JAX's conversions (its dataset.py: batch and frame_data) of the bytes
    mine = {"img": (got["img"].astype(np.float32) / 255.0 - 0.5) * 2.0,
            "mask": got["mask"].astype(np.float32),
            "normal": (2.0 * got["normal"].astype(np.float32) / 255.0 - 1.0
                       ).astype(np.float16).astype(np.float32)}
    assert want.keys() == mine.keys()
    for k in want:
        np.testing.assert_array_equal(mine[k], want[k], err_msg=k)


def test_repeated_batches_come_from_the_cache(scene, monkeypatch):
    ds = SceneDataset(scene)
    first = ds.batch_raw([1, 2])
    assert sorted(ds._cache) == [1, 2]
    calls = []
    decode = ds._native.batch
    monkeypatch.setattr(ds._native, "batch",
                        lambda fids: calls.append(list(fids)) or decode(fids))
    again = ds.batch_raw([2, 1, 4])
    assert calls == [[4]]                  # only the new frame decodes
    np.testing.assert_array_equal(again["img"][:2], first["img"][::-1])


def test_repeated_ids_in_one_native_batch(scene):
    """The loader decodes each slot on its own: an id twice in one call
    gives the same frame twice (the dataset asks for each frame once)."""
    ds = SceneDataset(scene)
    ref = SceneDataset(scene, use_native=False).batch_raw([3, 0, 3, 3])
    for _ in range(2):
        got = ds._native.batch([3, 0, 3, 3])
        assert got.keys() == ref.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_jpeg_frames_within_one_level_of_cv2(tmp_path):
    root = str(tmp_path / "jpeg")
    make_synthetic_scene(root, n_frames=3, H=48, W=64)
    yy, xx = np.mgrid[0:48, 0:64]
    rng = np.random.default_rng(1)
    for f in range(3):
        img = np.stack([(4 * xx + 10 * f) % 256, (5 * yy) % 256,
                        rng.integers(0, 256, (48, 64))], -1).astype(np.uint8)
        os.remove(osp.join(root, "imgs", f"{f}.png"))
        cv2.imwrite(osp.join(root, "imgs", f"{f}.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
    a = SceneDataset(root).batch_raw([0, 1, 2])
    b = SceneDataset(root, use_native=False).batch_raw([0, 1, 2])
    diff = np.abs(a["img"].astype(int) - b["img"].astype(int)).max()
    print(f"JPEG: max difference native vs cv2 {diff} grey levels")
    assert diff <= 1
    np.testing.assert_array_equal(a["mask"], b["mask"])


@pytest.fixture
def fresh_lib(tmp_path, monkeypatch):
    """An unbuilt loader library under tmp_path; returns a setter of its
    source."""
    def use(source=None):
        lib = NL.HostLibrary(source or "dataloader.cpp", "libsrloader",
                             NL._bind)
        monkeypatch.setattr(lib, "build_root", tmp_path / "build")
        monkeypatch.setattr(NL, "LIB", lib)
        return lib
    return use


@pytest.mark.parametrize("env,missing", [
    ("no compiler on PATH", "no C++ compiler"),
    ("CXX names none", "no C++ compiler"),
    ("CXX finds no headers", "no png.h / jpeglib.h")])
def test_missing_toolchain_selects_cv2(scene, fresh_lib, monkeypatch, capsys,
                                       tmp_path, env, missing):
    fresh_lib()
    if env == "no compiler on PATH":
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setenv("PATH", "")
    elif env == "CXX names none":
        monkeypatch.setenv("CXX", "no-such-c++-compiler")
    else:   # a compiler that fails every file, as it would on the includes
        cxx = tmp_path / "cxx"
        cxx.write_text("#!/bin/sh\nexit 1\n")
        cxx.chmod(0o755)
        monkeypatch.setenv("CXX", str(cxx))
    ds = SceneDataset(scene)
    out = capsys.readouterr().out.strip().splitlines()
    assert ds.decoder == "cv2" and ds._native is None
    assert len(out) == 1 and missing in out[0] and "cv2" in out[0]
    np.testing.assert_array_equal(
        ds.batch_raw(FIDS)["img"],
        SceneDataset(scene, use_native=False).batch_raw(FIDS)["img"])


def test_broken_source_raises(scene, fresh_lib, tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text(NL.LIB.source.read_text() + "\nthis is not C++;\n")
    lib = fresh_lib(str(broken))
    with pytest.raises(RuntimeError, match="failed on broken.cpp"):
        SceneDataset(scene)
    assert not lib.library_path().exists()


def test_corrupt_frame_raises(scene, tmp_path):
    root = str(tmp_path / "corrupt")
    shutil.copytree(scene, root)
    with open(osp.join(root, "imgs", "3.png"), "wb") as f:
        f.write(b"\x89PNG not really")
    ds = SceneDataset(root)
    assert ds.decoder == "native"
    ds.batch_raw([0, 1])
    with pytest.raises(IOError, match="unreadable"):
        ds.batch_raw([2, 3])
