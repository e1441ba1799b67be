"""One run of a cell on the port: set-up, warm-up, the measured window,
the traced steps, and what the correctness check needs from them.

The window drives ``Trainer.train_step`` as the train CLI's epoch loop does
(``cli/train.py``): frames from ``batch_iterator`` over a ``RandomSampler``
seeded by the run's seed, the stage's N frames a step, the learning rate of
the configuration's MultiStepLR at the stage's start epoch, ``opt_times``
at the count the published schedule has reached there, and each remesh
where ``forward_time % remesh_intersect`` puts it.  The per-epoch
checkpoint and the debug dump are not in it: an epoch of the published
subject is longer than a run.
"""
from __future__ import annotations

import gc
import os
import os.path as osp
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .cell import Cell
from .reference.run import deterministic
from .reference.synthetic_body import save_smpl_pickle, synthetic_body_model

BODY_FILE = "neutral_smpl_with_cocoplus_reg.pkl"


def schedule_state(conf: dict, stage: str, published_frames: int):
    """(start epoch, opt_times reached there, learning rate there) of a
    stage in the configuration's published schedule."""
    tr = conf["train"]
    order = ["coarse", "medium", "fine"]
    starts = {s: int(tr[s]["start_epoch"]) for s in order}
    epoch = starts[stage]
    steps = 0
    for s, nxt in zip(order, order[1:]):
        if starts[s] >= epoch:
            break
        end = min(starts[nxt], epoch)
        n = int(tr[s]["point_render"]["batch_size"])
        steps += (end - starts[s]) * (published_frames // n)
    lr = float(tr["learning_rate"]) * float(tr["scheduler"]["factor"]) ** sum(
        1 for m in tr["scheduler"]["milestones"] if epoch >= int(m))
    return epoch, steps, lr


def leaves(trainer) -> Dict[str, torch.Tensor]:
    out = {f"nets.{k}": p for k, p in trainer.nets.named_parameters()}
    out.update({f"bank.{k}": v for k, v in trainer.bank.items()})
    return out


def _clone(d):
    return {k: v.detach().clone() for k, v in d.items()}


@dataclass
class ProgramSide:
    """What the check compares of the program: its state before the first
    step and after the third, the gradient of the first step as Adam took
    it, the three losses, the remeshes and the skinner table."""
    p0: Dict[str, torch.Tensor] = field(default_factory=dict)
    g1: Dict[str, torch.Tensor] = field(default_factory=dict)
    p3: Dict[str, torch.Tensor] = field(default_factory=dict)
    losses: List[float] = field(default_factory=list)
    fids: List[List[int]] = field(default_factory=list)
    skinner_ws: Optional[torch.Tensor] = None
    remeshes: List[dict] = field(default_factory=list)

    def sdf_fit(self) -> Dict[str, torch.Tensor]:
        """The fitted SDF's state, as the first step found it."""
        n = len("nets.sdf.")
        return {k[n:]: v for k, v in self.p0.items()
                if k.startswith("nets.sdf.")}


class Session:
    """The program under test, set up for one cell and seed."""

    def __init__(self, cell: Cell, seed: int, workdir: str, device="cuda",
                 t0: Optional[float] = None):
        self.cell, self.seed, self.workdir = cell, int(seed), workdir
        self.device = torch.device(device)
        self.stage = cell.traffic["stage"]
        self.prog = ProgramSide()
        self.window_record: List[dict] = []
        self.extra: Dict[str, float] = {}
        self.phases: Dict[str, float] = {}
        self._capture = None
        self._t = time.perf_counter() if t0 is None else t0

    def _phase(self, name: str):
        """Record the seconds since the last phase ended (the first: since
        t0) under `name`."""
        self._sync()
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now

    # -- set-up ------------------------------------------------------------
    def write_inputs(self):
        """The body pickle and the rendered subject: the inputs both the
        program and the reference read."""
        from selfreconcode_tpu_torch.data.synthetic_subject import \
            make_synthetic_subject
        assets = osp.join(self.workdir, "assets")
        os.makedirs(assets, exist_ok=True)
        self.body_path = osp.join(assets, BODY_FILE)
        save_smpl_pickle(synthetic_body_model(), self.body_path)
        os.environ["SMPL_MODEL_DIR"] = assets
        t = self.cell.traffic
        self.scene = osp.join(self.workdir, "scene")
        make_synthetic_subject(self.scene, n_frames=int(
            self.cell.config["frames"]), H=int(t["H"]), W=int(t["W"]),
            verbose=False, device=str(self.device))

    def initial_weights(self, shapes):
        """The networks' and codes' initial tensors, drawn on the device
        (``weights.py``): the SDF's from the configuration's sdf_seed, the
        others' from the run's seed."""
        from .weights import frame_codes, net_weights
        c = self.cell.config
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        g_sdf = torch.Generator(device=self.device).manual_seed(
            int(c["sdf_seed"]))
        w = c["widths"]
        pe = 3 * (1 + 2 * int(c["conf"]["sdf_net"]["multires"]))
        nets = net_weights(shapes, int(w["sdf_skip"]), float(w["sdf_bias"]),
                           pe, g_sdf, g, self.device)
        codes = frame_codes(int(c["frames"]), {
            "dcond": int(c["conf"]["mlp_deformer"]["condlen"]),
            "rcond": int(c["conf"]["render_net"]["condlen"])}, g, self.device)
        return nets, codes

    def set_up(self):
        from selfreconcode_tpu_torch.cli.train import open_device
        from selfreconcode_tpu_torch.config import ConfigTree
        from selfreconcode_tpu_torch.data.dataset import (RandomSampler,
                                                          SceneDataset)
        from selfreconcode_tpu_torch.engine.trainer import Trainer
        from selfreconcode_tpu_torch.models.smpl import get_smpl
        c = self.cell.config
        open_device(str(self.device))
        self._phase("imports")
        self.write_inputs()
        self._phase("inputs")
        conf = ConfigTree(c["conf"])
        self.dataset = SceneDataset(self.scene, {
            "deformer": conf.get_int("mlp_deformer.condlen"),
            "renderer": conf.get_int("render_net.condlen")})
        res = {s: [tuple(r) for r in v] for s, v in c["resolutions"].items()}
        tr = Trainer(self.dataset, get_smpl(self.dataset.gender), conf, res,
                     seed=self.seed, skinner_res=tuple(c["skinner_res"]),
                     device=self.device)
        self.trainer = tr
        self._phase("trainer")
        self.init_nets, self.init_codes = self.initial_weights(
            tr.nets.state_dict())
        with torch.no_grad():
            tr.nets.load_state_dict(self.init_nets)
            for k, v in self.init_codes.items():
                tr.bank[k].copy_(v)
        self._phase("weights")
        # the fit draws from sdf_seed and runs deterministic algorithms (the
        # card's atomic sums would otherwise make every run's surface, and
        # so its template and its work, another); the steps draw from the
        # run's seed
        tr.generator.manual_seed(int(c["sdf_seed"]) + 1)
        with deterministic():
            tr.initialize_sdf(int(c["initial_iters"]))
        tr.generator.manual_seed(self.seed + 1)
        self._phase("sdf_fit")
        tr.set_stage(self.stage)
        _, tr.opt_times, self.lr = schedule_state(
            c["conf"], self.stage, int(c["published_frames"]))
        self.opt_times0 = tr.opt_times
        # every frame decoded and cached, as in each epoch after the first
        self.dataset.batch_raw(np.arange(self.dataset.frame_num))
        self.sampler = RandomSampler(self.dataset.frame_num, 1,
                                     conf.get_bool("train.shuffle"),
                                     seed=self.seed)
        self.batches = self._batches()
        self.prog.skinner_ws = tr.skinner.ws
        tr.remesh = self._remesh_hook(tr.remesh)
        self._phase("frames")

    def _batches(self):
        from selfreconcode_tpu_torch.data.dataset import batch_iterator
        while True:
            yield from batch_iterator(self.dataset, self.sampler,
                                      self.trainer.stage_cfg.N)

    def _remesh_hook(self, remesh):
        """The trainer's remesh, recording what the check compares: the SDF,
        the sweep box before it and the template it made (only while a
        capture is armed)."""
        tr = self.trainer

        def hooked(ratio):
            cap = self._capture
            if cap is not None:
                before = {"sdf": {k: v.detach().clone() for k, v in
                                  tr.nets.sdf.state_dict().items()},
                          "b_min": tr.b_min.copy(), "b_max": tr.b_max.copy(),
                          "grow_left": tr._grow_left().copy(),
                          "resolutions": tr.stage_cfg.resolutions,
                          "ratio": float(ratio)}
            out = remesh(ratio)
            if cap is not None:
                before.update(verts=tr.tmp.verts.detach().clone(),
                              faces=tr.tmp.faces.detach().clone())
                cap.append(before)
            return out
        return hooked

    def one_step(self, fed=None):
        """One step of the window's loop (on `fed`, a (fids, batch) taken
        from the feed, when given); returns (fids, info)."""
        fids, batch = fed if fed is not None else next(self.batches)
        info = self.trainer.train_step(np.asarray(fids), batch, self.lr)
        return fids, info

    def warm_up(self):
        """The first steps of the stage through the window's own call and
        feed, with the snapshots the check compares: the state before the
        first step, the gradient Adam took in it, the state after the
        third.  The first step is the stage's first remesh."""
        tr, p = self.trainer, self.prog
        n = int(self.cell.traffic["warmup_steps"])
        p.p0 = _clone(leaves(tr))
        self._capture = []
        for i in range(n):
            fids, info = self.one_step()
            p.fids.append([int(f) for f in fids])
            p.losses.append(float(info["loss"]))
            if i == 0:
                rm = self._capture[0]
                p.p0["template"] = rm["verts"]
                # Adam's first moment after one step is (1 - beta1) * g
                p.g1 = {k: (tr.optimizer.state[v]["exp_avg"].detach() / 0.1
                            if v in tr.optimizer.state
                            else torch.zeros_like(v.detach()))
                        for k, v in leaves(tr).items()}
                p.g1["template"] = tr.tmp.momentum.detach().clone()
                self.setup_remesh = rm
            if i == 2:
                p.p3 = _clone(leaves(tr))
                p.p3["template"] = tr.tmp.verts.detach().clone()
        self._capture = None
        self._phase("warm_up")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float):
        """Steps until `seconds` have passed; each step's shapes are kept
        for the FLOP count.  The last remesh in the window is recorded for
        the check."""
        tr = self.trainer
        self._capture = []
        self._sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            _, info = self.one_step()
            self.window_record.append({
                "nv": int(tr.tmp.verts.shape[0]),
                "finite": all(np.isfinite(v) for v in info.values())})
        self._sync()
        self.window_s = time.perf_counter() - t0
        self.prog.remeshes = self._capture[-1:]
        self._capture = None
        n = len(self.window_record)
        if n:
            steps = np.asarray(tr.timings["steps"][-n:])
            q = np.percentile(steps, [0, 25, 50, 75, 100])
            print(f"window: {steps.size} steps, step seconds min/p25/median/"
                  f"p75/max {np.round(q, 4).tolist()}, {len(self.prog.remeshes)}"
                  f" remesh recorded, template {self.window_record[-1]['nv']}"
                  f" vertices", file=sys.stderr, flush=True)

    def free(self):
        """Drop the program's state once the window's numbers are read;
        keeps what the check compares."""
        for k in ("trainer", "dataset", "batches", "sampler"):
            if hasattr(self, k):
                delattr(self, k)
        gc.collect()        # the remesh hook and the trainer refer to each other
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the traced steps ----------------------------------------------------
    @torch.no_grad()
    def splat_centres(self, fids):
        """Per frame of the next step, the template's splat centres (col,
        row, depth) as the splat sees them, from the program's state by the
        reference's deformer and camera: the splat yardstick's input."""
        from .reference.camera import Camera, transform_points_screen
        from .reference.deformer import deformer_apply
        from .reference.mathops import quat2mat
        from .reference.translator import TranslatorNet
        tr, b = self.trainer, self.trainer.bank
        cfg = tr.stage_cfg
        t = TranslatorNet(cond_size=tr.nets.translator.cond_size,
                          multires=tr.nets.translator.multires).to(self.device)
        t.load_state_dict(tr.nets.translator.state_dict())
        f = torch.as_tensor(np.asarray(fids), device=self.device)
        N, nv = len(fids), tr.tmp.verts.shape[0]
        binds = torch.arange(N, device=self.device).repeat_interleave(nv)
        dv = deformer_apply(t, tr.skinner, tr.tmp.verts.repeat(N, 1), binds,
                            b["dcond"][f], b["poses"][f], b["trans"][f],
                            tr.opt_times / 2500.0 + 0.5)[0].reshape(N, nv, 3)
        cam = Camera(focal=b["focal_length"].reshape(2),
                     principal=b["princeple_points"].reshape(2),
                     R=quat2mat(b["cam2world_coord_quat"].reshape(1, 4))[0],
                     T=b["world2cam_coord_trans"].reshape(3), H=cfg.H,
                     W=cfg.W)
        r_pix = cfg.radius * cfg.W / 2.0
        return [(transform_points_screen(cam, d), r_pix, cfg.H, cfg.W)
                for d in dv]

    def traced_steps(self, n: int):
        """n steps under the profiler for the metrics, then one with the
        host's ops for the breakdown; a step that would remesh is taken
        untraced first.  Returns (the n steps, the host step)."""
        from .trace import trace_step
        tr = self.trainer
        out = []
        while len(out) < n + 1:
            if tr.forward_time % tr.stage_cfg.remesh_intersect == 0:
                self.one_step()
                continue
            fed = next(self.batches)
            centres = self.splat_centres(fed[0]) if len(out) < n else []
            self._sync()
            out.append(trace_step(lambda: self.one_step(fed), centres,
                                  host_ops=len(out) == n))
        return out[:n], out[n]
