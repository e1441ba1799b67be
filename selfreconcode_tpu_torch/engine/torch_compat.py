"""Reference-checkpoint (.pth) loader (torch port of
``selfreconcode_tpu/engine/torch_compat.py``).

A reference checkpoint is one ``torch.save`` dict holding ``{"epoch",
"model_state_dict"}`` and the dataset-owned optimizables at the top level
(``poses, trans, shape, dcond, rcond`` and the four camera parameters;
utils/utils.py:257-264 of the reference).  Its state_dict already uses the
port's key names (``interop.py``): ``sdf.lin{l}.*``,
``deformer.defs.0.lin{l}.*``, ``netRender.lin{l}.*``.

Dropped, as the reference loader and JAX's drop them: every ``engine.*`` key
(utils/utils.py:268) and the skinner's ``deformer.defs.1.*`` buffers (the
port rebuilds the weight volume from the body).  What remains loads with
``strict=True``, so a missing or extra layer raises
(``checkpoint.restore_from_reference``).

Every torch archive, the port's ``.pt`` included, is read weights-only: a
file that pickles anything but tensors and plain containers is refused, so
no code in a checkpoint runs.
"""
from __future__ import annotations

import pickle
import re
import zipfile

import numpy as np
import torch

CAM_KEYS = ("focal_length", "princeple_points", "cam2world_coord_quat",
            "world2cam_coord_trans")
_SDF_KEY = re.compile(r"lin\d+\.(weight_v|weight_g|bias)$")


def is_torch_checkpoint(path: str) -> bool:
    """True for torch.save archives (zip format, torch >= 1.6) and legacy
    torch pickles (protocol-2 magic number; JAX's torch_compat.py:31-51)."""
    if zipfile.is_zipfile(path):
        try:
            with zipfile.ZipFile(path) as z:
                return any(n.endswith("data.pkl") for n in z.namelist())
        except (OSError, zipfile.BadZipFile):
            return False
    # a legacy torch file begins with pickle.dump(MAGIC_NUMBER, protocol=2),
    # MAGIC_NUMBER = 0x1950a86a20f9469cfc6c: the full 14-byte prefix keeps
    # protocol-2 pickles of other checkpoints off the torch route
    legacy = b"\x80\x02\x8a\x0a\x6c\xfc\x9c\x46\xf9\x20\x6a\xa8\x50\x19"
    try:
        with open(path, "rb") as f:
            return f.read(len(legacy)) == legacy
    except OSError:
        return False


def load_torch(path: str):
    """torch.load on the host, weights-only: a port ``.pt`` and a reference
    ``.pth`` hold tensors, dicts, lists, tuples, numbers, strings and None
    (JAX's torch_compat.py:90 loads with weights_only=False, which runs any
    pickled code).  ValueError naming the class when the file holds
    another."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        why = [ln.strip() for ln in str(e).splitlines() if "Unpickler" in ln]
        raise ValueError(f"{path}: a torch archive that pickles more than "
                         f"tensors, refused "
                         f"({(why or [str(e)])[0][:200]})") from e


def sdf_state_from_reference(saved) -> dict:
    """An SDFNet state_dict from a loaded reference .pth: a full checkpoint
    (its ``sdf.*`` entries) or a bare, unprefixed ``lin*`` state_dict (the
    ``initial_sdf_idr_*.pth`` cache, which the reference loads at
    utils/utils.py:279-282)."""
    if isinstance(saved, dict) and "model_state_dict" in saved:
        sd = {k[4:]: v for k, v in saved["model_state_dict"].items()
              if k.startswith("sdf.")}
    elif isinstance(saved, dict):
        sd = dict(saved)
    else:
        raise ValueError(f"not an SDF state_dict: a {type(saved).__name__}")
    sd = {k: v for k, v in sd.items() if _SDF_KEY.fullmatch(k)}
    if not sd:
        raise KeyError("no 'lin*' SDF layers in the checkpoint")
    return sd


def parse_reference(saved: dict):
    """(epoch, nets state_dict, dataset state) of a loaded reference .pth
    (JAX's load_reference_pth).  The nets' entries drop every ``engine.*``
    key and the ``deformer.defs.1.*`` skinner buffers; the dataset state
    holds numpy poses / trans / shape / dcond / rcond and the camera under
    the reference's names, for the caller to map onto the bank."""
    def arr(t):
        return np.asarray(t.detach().cpu() if hasattr(t, "detach") else t,
                          np.float32)
    ds = {"camera": {k: arr(saved[k]).reshape(-1) for k in CAM_KEYS
                     if k in saved}}
    for k in ("poses", "trans", "shape", "dcond", "rcond"):
        if k in saved:
            ds[k] = arr(saved[k])
    nets = {k: v for k, v in saved["model_state_dict"].items()
            if "engine." not in k and not k.startswith("deformer.defs.1.")}
    return int(saved.get("epoch", 0)), nets, ds


def frames(a: np.ndarray, F: int, what: str) -> np.ndarray:
    """The first F rows of a per-frame array, each row flattened (JAX's
    torch_compat.py:142-158: slicing, not a reshape to F rows, which would
    re-stride a longer bank)."""
    a = a.reshape(a.shape[0], -1)
    if a.shape[0] < F:
        raise ValueError(f"the checkpoint's {what} has {a.shape[0]} frames, "
                         f"the dataset {F}")
    return a[:F]
