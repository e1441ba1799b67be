"""Conversion between the JAX package's numpy pytrees and the port's state
(numpy only; nothing here imports JAX).

Key names follow the reference checkpoints (the mapping of
``selfreconcode_tpu/engine/torch_compat.py``):

  params["sdf"][l]    {v, g, b} <-> sdf.lin{l}.weight_v / weight_g / bias
  params["trans"][l]  {w, b}    <-> deformer.defs.0.lin{l}.weight / bias
  params["render"][l] {v, g, b} <-> netRender.lin{l}.weight_v / weight_g / bias

weight_g is stored (out, 1) as torch.nn.utils.weight_norm stores it.  The
bank's latents are ``dcond`` / ``rcond`` and the camera parameters sit at
the top level, as in a reference checkpoint.
"""
from __future__ import annotations

import numpy as np

_PREFIX = {"sdf": "sdf", "trans": "deformer.defs.0", "render": "netRender"}


def params_from_jax(params_np: dict) -> dict:
    """{"sdf","trans","render"} layer lists -> one flat state_dict (numpy)."""
    sd = {}
    for tower, prefix in _PREFIX.items():
        for l, layer in enumerate(params_np[tower]):
            base = f"{prefix}.lin{l}"
            if "v" in layer:
                sd[f"{base}.weight_v"] = np.asarray(layer["v"], np.float32)
                sd[f"{base}.weight_g"] = np.asarray(
                    layer["g"], np.float32).reshape(-1, 1)
            else:
                sd[f"{base}.weight"] = np.asarray(layer["w"], np.float32)
            sd[f"{base}.bias"] = np.asarray(layer["b"], np.float32)
    return sd


def params_to_jax(sd: dict) -> dict:
    """Inverse of params_from_jax (accepts numpy arrays or tensors)."""
    def arr(x):
        return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x,
                          np.float32)

    out = {}
    for tower, prefix in _PREFIX.items():
        layers, l = [], 0
        while True:
            base = f"{prefix}.lin{l}"
            if f"{base}.weight_v" in sd:
                layers.append({"v": arr(sd[f"{base}.weight_v"]),
                               "g": arr(sd[f"{base}.weight_g"]).reshape(-1),
                               "b": arr(sd[f"{base}.bias"])})
            elif f"{base}.weight" in sd:
                layers.append({"w": arr(sd[f"{base}.weight"]),
                               "b": arr(sd[f"{base}.bias"])})
            else:
                break
            l += 1
        out[tower] = layers
    return out


_BANK_NAMES = {"cond_deformer": "dcond", "cond_renderer": "rcond"}


def bank_from_jax(bank_np: dict) -> dict:
    """JAX bank {poses, trans, cond_*, camera{...}} -> flat port bank."""
    out = {}
    for k, v in bank_np.items():
        if k == "camera":
            out.update({ck: np.asarray(cv, np.float32)
                        for ck, cv in v.items()})
        else:
            out[_BANK_NAMES.get(k, k)] = np.asarray(v, np.float32)
    return out


def bank_to_jax(bank: dict) -> dict:
    """Inverse of bank_from_jax."""
    inv = {v: k for k, v in _BANK_NAMES.items()}
    cam_keys = ("focal_length", "princeple_points", "cam2world_coord_quat",
                "world2cam_coord_trans")
    out = {"camera": {}}
    for k, v in bank.items():
        a = np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                       np.float32)
        if k in cam_keys:
            out["camera"][k] = a
        else:
            out[inv.get(k, k)] = a
    return out


def template_from_jax(tmp_np: dict) -> dict:
    """JAX TemplateState fields (padded, with validity masks) -> the port's
    exact-size {verts, faces, momentum}."""
    vv = np.asarray(tmp_np["vert_valid"], bool)
    fv = np.asarray(tmp_np["face_valid"], bool)
    return {"verts": np.asarray(tmp_np["verts"], np.float32)[vv],
            "faces": np.asarray(tmp_np["faces"], np.int64)[fv],
            "momentum": np.asarray(tmp_np["momentum"], np.float32)[vv]}
