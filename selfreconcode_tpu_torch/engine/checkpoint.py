"""Checkpoint save/load in torch format: one ``torch.save`` dict holding the
epoch and step counters, the stage, the sweep bbox, the nets' state_dict
(reference key names), the bank, the Adam state and the template."""
from __future__ import annotations

import numpy as np
import torch

from .trainer import make_template


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


def load_checkpoint(path: str, trainer, sdf_state=None) -> int:
    """Restore trainer state in place; returns the saved epoch.  sdf_state
    (an SDFNet state_dict) replaces the checkpoint's SDF and restarts Adam."""
    z = torch.load(path, map_location=trainer.device)
    trainer.b_min = np.asarray(z["bbox"][0], np.float32)
    trainer.b_max = np.asarray(z["bbox"][1], np.float32)
    trainer.nets.load_state_dict(z["nets"])
    if sdf_state is not None:
        trainer.nets.sdf.load_state_dict(sdf_state)
    with torch.no_grad():
        for k, v in z["bank"].items():
            trainer.bank[k].copy_(v)
    trainer.optimizer = trainer._make_optimizer()
    trainer._step_fn = None
    if sdf_state is None:
        trainer.optimizer.load_state_dict(z["optimizer"])
    if z["stage"]:
        trainer.set_stage(z["stage"])
    if z["tmp"] is not None:
        trainer.tmp = make_template(**z["tmp"])
    trainer.opt_times = z["opt_times"]
    trainer.forward_time = z["forward_time"]
    return z["epoch"]
