"""Checkpoint save and load.

The port saves one ``torch.save`` dict: the epoch and step counters, the
stage, the sweep bbox, the nets' state_dict (reference key names), the bank,
the Adam state and the template.

``load_checkpoint`` reads three formats, told apart by the file's content,
never by its name:

* a torch archive holding ``nets``: the port's own ``.pt``;
* a torch archive holding ``model_state_dict``: a reference ``.pth``
  (parsed by ``torch_compat.py``; Adam restarts);
* anything else must be a JAX package checkpoint, a pickle of numpy trees
  (written by its engine/checkpoint.py:31-55).  It is read by an unpickler
  that builds numpy arrays and the two optimizer-state records of JAX's Adam
  and refuses every other class, so no code of JAX or of its optimizer
  library runs or needs to be installed.

Torch archives are read weights-only (``torch_compat.load_torch``).  Every
route ends the same way (``_finish_load``): a fresh Adam, holding the file's
moments where the format keeps them, and the restored bank written back
into the dataset (``SceneDataset.load_bank``), as JAX's loaders do.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from ..interop import bank_from_jax, params_from_jax, template_from_jax
from . import torch_compat
from .trainer import make_template


def _finish_load(trainer, moments=None):
    """The tail of every load route: a fresh Adam (``moments()`` then fills
    it from the file, where the route has moments to keep), the step
    rebuilt at its next call, and the restored bank written back into the
    dataset (JAX's engine/checkpoint.py:112, torch_compat.py:169)."""
    trainer.optimizer = trainer._make_optimizer()
    trainer._step_fn = None
    if moments is not None:
        moments()
    trainer.dataset.load_bank(trainer.bank)


def save_checkpoint(path: str, trainer, epoch: int):
    tmp = trainer.tmp
    torch.save({
        "epoch": epoch,
        "opt_times": trainer.opt_times,
        "forward_time": trainer.forward_time,
        "stage": trainer.stage_cfg.name if trainer.stage_cfg else None,
        "bbox": (trainer.b_min.tolist(), trainer.b_max.tolist()),
        "nets": trainer.nets.state_dict(),
        "bank": {k: v.detach() for k, v in trainer.bank.items()},
        "optimizer": trainer.optimizer.state_dict(),
        "tmp": None if tmp is None else {"verts": tmp.verts,
                                         "faces": tmp.faces,
                                         "momentum": tmp.momentum},
    }, path)


# ---------------------------------------------------------------------------
# JAX checkpoints
# ---------------------------------------------------------------------------

class AdamState(tuple):
    """Stand-in for the (count, mu, nu) record of JAX's Adam state."""

    def __new__(cls, *args):
        return super().__new__(cls, args)


class EmptyState(tuple):
    """Stand-in for the empty record that JAX's Adam chains after it."""

    def __new__(cls, *args):
        return super().__new__(cls, args)


# numpy's reconstructors (numpy 2 pickles from numpy._core, 1.x from
# numpy.core); the optimizer records by class name, from whichever module
_NUMPY_GLOBALS = {("numpy._core.multiarray", "_reconstruct"),
                  ("numpy.core.multiarray", "_reconstruct"),
                  ("numpy", "dtype"), ("numpy", "ndarray")}
_OPT_RECORDS = {"ScaleByAdamState": AdamState, "EmptyState": EmptyState}


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        if name in _OPT_RECORDS:
            return _OPT_RECORDS[name]
        raise pickle.UnpicklingError(
            f"refusing class {module}.{name}: a JAX checkpoint holds only "
            f"numpy arrays and Adam state records")


def load_jax_pickle(path: str) -> dict:
    """The payload of a JAX package checkpoint (numpy leaves); ValueError
    when the file is no such pickle."""
    try:
        with open(path, "rb") as f:
            payload = _JaxCheckpointUnpickler(f).load()
    except (pickle.UnpicklingError, EOFError, ValueError, TypeError,
            AttributeError, IndexError, KeyError) as e:
        raise ValueError(f"{path}: not a torch archive, and not a JAX "
                         f"checkpoint pickle ({e})") from e
    if not (isinstance(payload, dict) and {"params", "bank"} <= set(payload)):
        found = (sorted(payload) if isinstance(payload, dict)
                 else type(payload).__name__)
        raise ValueError(f"{path}: a pickle, but not a JAX checkpoint "
                         f"(no 'params' and 'bank'; found {found})")
    return payload


def _restore_jax_adam(trainer, opt_state):
    """Adam moments of a JAX checkpoint into the (fresh) torch Adam, matched
    by name through interop's key maps: mu -> exp_avg, nu -> exp_avg_sq,
    count -> every parameter's step.  JAX's update mu_hat / (sqrt(nu_hat) +
    eps) is torch's, so the moments carry over unchanged.  As JAX's
    _restore_opt_state (engine/checkpoint.py:116-127), a state that does
    not fit (other leaves, another shape) restarts Adam."""
    def restart(why):
        print(f"JAX checkpoint: {why}; Adam restarts", flush=True)

    adam = [s for s in opt_state if isinstance(s, AdamState)]
    if len(adam) != 1 or len(adam[0]) != 3:
        return restart("no single Adam state record")
    count, mu, nu = adam[0]
    count = int(np.asarray(count))
    params = {**dict(trainer.nets.named_parameters()), **trainer.bank}
    state = {p: {"step": torch.tensor(float(count))} for p in params.values()}
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        try:
            flat = {**params_from_jax(tree[0]), **bank_from_jax(tree[1])}
        except (KeyError, TypeError, IndexError) as e:
            return restart(f"its {key} is no (params, bank) tree ({e!r})")
        if set(flat) != set(params):
            return restart(f"its {key} has other leaves than the nets and "
                           f"the bank ({sorted(set(flat) ^ set(params))[:4]})")
        for n, v in flat.items():
            p = params[n]
            if v.shape != tuple(p.shape):
                return restart(f"its {key} of {n} has shape {v.shape}, the "
                               f"parameter {tuple(p.shape)}")
            state[p][key] = torch.as_tensor(v).to(p.device)
    if count > 0:
        trainer.optimizer.state.update(state)


def restore_from_jax(payload: dict, trainer, sdf_state=None) -> int:
    """Load a JAX checkpoint's payload into a live Trainer; returns its
    epoch.  Adam keeps the file's moments unless an sdf_state replaces the
    SDF (JAX's engine/checkpoint.py:102-103).  The TPU capacity fields
    (caps, mc_caps) have no counterpart in the port and are ignored."""
    dev = trainer.device
    if payload.get("bbox"):
        trainer.b_min = np.asarray(payload["bbox"][0], np.float32)
        trainer.b_max = np.asarray(payload["bbox"][1], np.float32)
    sd = {k: torch.as_tensor(v) for k, v in
          params_from_jax(payload["params"]).items()}
    trainer.nets.load_state_dict(sd, strict=True)
    if sdf_state is not None:
        trainer.nets.sdf.load_state_dict(sdf_state)
    bank = bank_from_jax(payload["bank"])
    if set(bank) != set(trainer.bank):
        raise ValueError(f"the JAX bank holds {sorted(bank)}, the trainer's "
                         f"{sorted(trainer.bank)}")
    with torch.no_grad():
        for k, v in bank.items():
            trainer.bank[k].copy_(torch.as_tensor(v).reshape(
                trainer.bank[k].shape))
    _finish_load(trainer, None if sdf_state is not None else
                 lambda: _restore_jax_adam(trainer, payload["opt_state"]))
    if payload.get("stage"):
        trainer.set_stage(payload["stage"])
    t = template_from_jax(payload["tmp"]) if payload.get("tmp") else None
    if t is not None and t["verts"].shape[0]:
        # (a JAX trainer that never remeshed saves an all-padding template)
        trainer.tmp = make_template(
            torch.as_tensor(t["verts"], device=dev),
            torch.as_tensor(t["faces"], device=dev),
            torch.as_tensor(t["momentum"], device=dev))
    trainer.opt_times = int(payload["opt_times"])
    trainer.forward_time = int(payload["forward_time"])
    return int(payload["epoch"])


# ---------------------------------------------------------------------------
# Loading any format
# ---------------------------------------------------------------------------

def restore_from_reference(saved: dict, trainer, sdf_state=None) -> int:
    """Load a reference checkpoint (loaded dict) into a live Trainer; returns
    its epoch.  Adam restarts: the reference never saves its moments
    (utils/utils.py:257-264), and neither does a .pth.  The stage, the
    template and the step counters stay as they are."""
    epoch, sd, ds = torch_compat.parse_reference(saved)
    if sdf_state is not None:
        sd = {k: v for k, v in sd.items() if not k.startswith("sdf.")}
        sd.update({f"sdf.{k}": v for k, v in sdf_state.items()})
    trainer.nets.load_state_dict(sd, strict=True)
    dataset, bank = trainer.dataset, trainer.bank
    F = dataset.frame_num
    new = dict(ds["camera"])
    for k in ("poses", "trans", "dcond", "rcond"):
        if k in ds and k in bank:
            new[k] = torch_compat.frames(ds[k], F, k)
    with torch.no_grad():
        for k, v in new.items():
            bank[k].copy_(torch.as_tensor(v).reshape(bank[k].shape))
    if "shape" in ds:
        dataset.shape = ds["shape"].reshape(-1)
    _finish_load(trainer)
    return epoch


def restore_from_port(z: dict, trainer, sdf_state=None) -> int:
    """Load the port's own checkpoint (loaded dict) into a live Trainer;
    Adam keeps the file's moments unless an sdf_state replaces the SDF."""
    trainer.b_min = np.asarray(z["bbox"][0], np.float32)
    trainer.b_max = np.asarray(z["bbox"][1], np.float32)
    trainer.nets.load_state_dict(z["nets"])
    if sdf_state is not None:
        trainer.nets.sdf.load_state_dict(sdf_state)
    with torch.no_grad():
        for k, v in z["bank"].items():
            trainer.bank[k].copy_(v)
    _finish_load(trainer, None if sdf_state is not None else
                 lambda: trainer.optimizer.load_state_dict(z["optimizer"]))
    if z["stage"]:
        trainer.set_stage(z["stage"])
    if z["tmp"] is not None:
        trainer.tmp = make_template(**{k: v.to(trainer.device)
                                       for k, v in z["tmp"].items()})
    trainer.opt_times = z["opt_times"]
    trainer.forward_time = z["forward_time"]
    return z["epoch"]


def _torch_kind(z) -> str:
    if isinstance(z, dict) and "nets" in z:
        return "port"
    if isinstance(z, dict) and "model_state_dict" in z:
        return "reference"
    return "other"


def load_checkpoint(path: str, trainer, sdf_state=None) -> int:
    """Restore trainer state in place from a port ``.pt``, a reference
    ``.pth`` or a JAX pickle; returns the saved epoch.  sdf_state (an
    SDFNet state_dict, from ``load_sdf_state``) replaces the checkpoint's
    SDF and restarts Adam (the reference's --sdf-model).  Any other file
    raises ValueError."""
    if torch_compat.is_torch_checkpoint(path):
        z = torch_compat.load_torch(path)
        kind = _torch_kind(z)
        if kind == "port":
            return restore_from_port(z, trainer, sdf_state)
        if kind == "reference":
            return restore_from_reference(z, trainer, sdf_state)
        found = (f"keys {sorted(map(str, z))[:8]}" if isinstance(z, dict)
                 else f"a {type(z).__name__}")
        raise ValueError(f"{path}: a torch archive with neither 'nets' (a "
                         f"port checkpoint) nor 'model_state_dict' (a "
                         f"reference checkpoint); found {found}")
    return restore_from_jax(load_jax_pickle(path), trainer, sdf_state)


def load_sdf_state(path: str) -> dict:
    """An SDFNet state_dict (``lin*`` keys) from any checkpoint that holds an
    SDF: a port ``.pt`` (its ``sdf.*`` nets), a reference ``.pth``, full or
    a bare SDF state_dict, or a JAX pickle (``params["sdf"]``); the inputs
    of JAX's --sdf-model (cli/train.py:119-132) and the port's own."""
    if torch_compat.is_torch_checkpoint(path):
        z = torch_compat.load_torch(path)
        if _torch_kind(z) == "port":
            return {k[4:]: v for k, v in z["nets"].items()
                    if k.startswith("sdf.")}
        return torch_compat.sdf_state_from_reference(z)
    sdf = load_jax_pickle(path)["params"]["sdf"]
    return {k[4:]: torch.as_tensor(v) for k, v in params_from_jax(
        {"sdf": sdf, "trans": [], "render": []}).items()}
