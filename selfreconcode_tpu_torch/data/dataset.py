"""Scene dataset and the per-frame parameter bank (torch port of
``selfreconcode_tpu/data/dataset.py``).

The dataset does host-side IO only (PNG or JPEG frames): images load BGR as
uint8, masks as any-channel > 0, normals RGB.  Frames decode with the native
loader (``native_loader.py``: a C++ thread pool over libpng and libjpeg,
the frames of a batch in parallel) where its toolchain is present, else
with cv2 (``decoder`` says which), and are cached after the first read.
``param_bank`` returns the per-frame optimizables (poses, trans, camera,
both latent banks) as numpy arrays under the reference checkpoint's names.
"""
from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Dict, List, Optional

import cv2
import numpy as np

from ..utils.math import dct_space


def frame_images(data_root: str) -> List[str]:
    """The scene's frame images (imgs/<int>.jpg or .png, any zero padding)
    in frame order."""
    imgs: List[str] = []
    for ext in (".jpg", ".png"):
        imgs.extend(glob(osp.join(data_root, "imgs/*" + ext)))
    return sorted(imgs, key=lambda x: int(osp.basename(x).split(".")[0]))


class SceneDataset:
    def __init__(self, data_root: str,
                 conds_lens: Optional[Dict[str, int]] = None, seed: int = 0,
                 use_native: bool = True):
        self.root = data_root
        self._read_meta()
        self._cache: Dict[int, dict] = {}
        self._native = None
        self.decoder = "cv2"
        if use_native:
            from .native_loader import NativeLoader, toolchain
            missing = toolchain()
            if missing:
                print(f"native frame loader: {missing}; frames decode with "
                      f"cv2", flush=True)
            else:
                self._native = NativeLoader.create(
                    self.img_ns, self.mask_ns,
                    self.normal_ns if any(self.normal_ns) else None,
                    self.H, self.W)
                self.decoder = "native"
        rng = np.random.default_rng(seed)
        self.conds: Dict[str, np.ndarray] = {}
        ncoef = max(self.frame_num // 5, 1)
        basis = dct_space(ncoef, self.frame_num)             # (ncoef, F)
        for name, length in (conds_lens or {}).items():
            coef = 0.1 * rng.standard_normal((length, ncoef)).astype(
                np.float32)
            self.conds[name] = (coef @ basis).T.copy()      # (F, length)

    def _read_meta(self):
        imgs = frame_images(self.root)
        if not imgs:
            raise FileNotFoundError(f"no images under {self.root}/imgs")
        self.img_ns = imgs
        self.frame_num = len(imgs)
        self.mask_ns = []
        for ind, img_n in enumerate(self.img_ns):
            stem = osp.basename(img_n).split(".")[0]
            if int(stem) != ind:
                raise ValueError(f"frame {ind} is named {img_n}")
            mask_n = osp.join(self.root, f"masks/{stem}.png")
            if not osp.isfile(mask_n):
                raise FileNotFoundError(mask_n)
            self.mask_ns.append(mask_n)
        self.H, self.W = self._imread(self.mask_ns[0]).shape[:2]
        data = np.load(osp.join(self.root, "smpl_rec.npz"))
        self.poses = data["poses"].astype(np.float32).reshape(-1, 24, 3)
        self.trans = data["trans"].astype(np.float32).reshape(-1, 3)
        self.shape = data["shape"].astype(np.float32).reshape(-1)
        self.gender = str(data["gender"]) if "gender" in data else "neutral"
        if "vid_seg_indices" in data:
            self.video_segmented_index = list(
                np.asarray(data["vid_seg_indices"]).tolist()[:-1])
        else:
            self.video_segmented_index = []
        cam = np.load(osp.join(self.root, "camera.npz"))
        self.camera_params = {
            "focal_length": np.array([cam["fx"], cam["fy"]],
                                     np.float32).reshape(2),
            "princeple_points": np.array([cam["cx"], cam["cy"]],
                                         np.float32).reshape(2),
            "cam2world_coord_quat": cam["quat"].astype(np.float32).reshape(4),
            "world2cam_coord_trans": cam["T"].astype(np.float32).reshape(3),
        }
        self.has_normals = osp.isdir(osp.join(self.root, "normals"))
        # each frame's normal map, "" where it has none
        self.normal_ns = []
        for img_n in self.img_ns:
            p = img_n.replace("/imgs/", "/normals/")[:-3] + "png"
            self.normal_ns.append(p if osp.isfile(p) else "")

    @staticmethod
    def _imread(path):
        img = cv2.imread(path)
        if img is None:
            raise IOError(f"cannot read image {path}")
        return img

    def frame_data(self, fid: int) -> dict:
        """uint8 image (H,W,3) BGR, uint8 mask (H,W) in {0,1}, optional uint8
        normal (H,W,3) RGB; cached after the first read."""
        return self._frames([fid])[0]

    def _decode_cv2(self, fid: int) -> dict:
        out = {"img": self._imread(self.img_ns[fid]),
               "mask": (self._imread(self.mask_ns[fid]) > 0).any(-1).astype(
                   np.uint8)}
        if self.normal_ns[fid]:
            out["normal"] = np.ascontiguousarray(
                self._imread(self.normal_ns[fid])[:, :, ::-1])
        return out

    def _decode_native(self, fids) -> Dict[int, dict]:
        """One native batch for the frames with a normal map and one for
        those without (a batch returns normals only when all have one)."""
        out = {}
        for group in ([f for f in fids if self.normal_ns[f]],
                      [f for f in fids if not self.normal_ns[f]]):
            if group:
                raw = self._native.batch(group)
                out.update({f: {k: v[i] for k, v in raw.items()}
                            for i, f in enumerate(group)})
        return out

    def _frames(self, fids) -> List[dict]:
        fids = [int(f) for f in fids]
        new = [f for f in dict.fromkeys(fids) if f not in self._cache]
        if self._native is not None:
            decoded = self._decode_native(new)
        else:
            decoded = {f: self._decode_cv2(f) for f in new}
        self._cache.update(decoded)
        return [self._cache[f] for f in fids]

    def batch_raw(self, fids) -> dict:
        """uint8 batch: img (B,H,W,3) BGR, mask (B,H,W), optional normal."""
        frames = self._frames(fids)
        out = {"img": np.stack([f["img"] for f in frames]),
               "mask": np.stack([f["mask"] for f in frames])}
        if all("normal" in f for f in frames):
            out["normal"] = np.stack([f["normal"] for f in frames])
        return out

    def param_bank(self) -> dict:
        """Per-frame optimizables as numpy, under the reference names."""
        bank = {"poses": self.poses.copy(), "trans": self.trans.copy()}
        if "deformer" in self.conds:
            bank["dcond"] = self.conds["deformer"].copy()
        if "renderer" in self.conds:
            bank["rcond"] = self.conds["renderer"].copy()
        bank.update({k: v.copy() for k, v in self.camera_params.items()})
        return bank

    def load_bank(self, bank: dict):
        """Write a restored bank back (every checkpoint load does, as JAX's
        dataset.py:191-198): the flat names of ``param_bank``, as numpy
        arrays or tensors.  Readers of the host copy (the debug dump's
        camera, the raster footprint, the texture CLI) then see the trained
        camera, poses and trans.  Copies: a CPU tensor's numpy view would
        follow the bank as it trains."""
        def arr(v):
            return np.array(v.detach().cpu() if hasattr(v, "detach") else v,
                            np.float32)
        self.poses = arr(bank["poses"]).reshape(self.poses.shape)
        self.trans = arr(bank["trans"]).reshape(self.trans.shape)
        for k in self.camera_params:
            self.camera_params[k] = arr(bank[k]).reshape(
                self.camera_params[k].shape)
        for name, key in (("deformer", "dcond"), ("renderer", "rcond")):
            if name in self.conds:
                self.conds[name] = arr(bank[key])

    def window_indices(self, fids, batchsize: int):
        """(windows (B, batchsize), offsets (B,)): a window of frame ids
        around each fid, clamped to its video segment (a segment shorter than
        the window repeats its last frame)."""
        fids = np.asarray(fids, np.int64)
        segments = [0] + list(self.video_segmented_index) + [self.frame_num]
        windows = np.zeros((len(fids), batchsize), np.int64)
        starts = np.zeros_like(fids)
        for b, fid in enumerate(fids):
            lo, hi = 0, self.frame_num
            for si in range(len(segments) - 1):
                if segments[si] <= fid < segments[si + 1]:
                    lo, hi = segments[si], segments[si + 1]
                    break
            s = fid - batchsize // 2
            e = s + batchsize
            if s < lo:
                e += lo - s
                s = lo
            if e > hi:
                s -= e - hi
                e = hi
            s = max(s, lo)
            starts[b] = s
            windows[b] = np.clip(s + np.arange(batchsize), lo, hi - 1)
        return windows, fids - starts


class RandomSampler:
    """Frame-id sampler (intersect frames apart, shuffled per epoch)."""

    def __init__(self, length: int, intersect: int = 1, shuffle: bool = True,
                 seed: int = 0):
        self.length = length
        self.intersect = intersect
        self.shuffle = shuffle
        self.n = (length - 1) // intersect + 1
        self.start = length - intersect * (self.n - 1)
        self._rng = np.random.default_rng(seed)

    def epoch_ids(self) -> np.ndarray:
        if self.shuffle:
            start = int(self._rng.integers(0, self.start))
            index = np.arange(start, self.length, self.intersect)
            return index[self._rng.permutation(self.n)]
        return np.arange(0, self.length, self.intersect)


def batch_iterator(dataset: SceneDataset, sampler: RandomSampler,
                   batch_size: int):
    """Yield (fids (B,), uint8 batch dict) over one epoch; a short last group
    is dropped."""
    ids = sampler.epoch_ids()
    for i in range(0, len(ids) - batch_size + 1, batch_size):
        g = ids[i:i + batch_size]
        yield g, dataset.batch_raw(g)


def make_synthetic_scene(root: str, n_frames: int = 8, H: int = 96,
                         W: int = 96, seed: int = 0):
    """Write a tiny scene in the reference's on-disk layout (imgs/ masks/
    camera.npz smpl_rec.npz): a moving disk silhouette with flat colour.

    The images are the JAX package's generator's.  The camera follows the
    reference data's convention: it sits at the origin (T = 0) and the
    body's 2.5 m distance is in `trans`, so the fixed frontal camera of the
    inference's offset-only render (at the mean trans) sees the body from
    outside.  The JAX generator puts the distance in T instead; camera-space
    geometry is the same."""
    rng = np.random.default_rng(seed)
    os.makedirs(osp.join(root, "imgs"), exist_ok=True)
    os.makedirs(osp.join(root, "masks"), exist_ok=True)
    fx = fy = 0.9 * W
    cx, cy = W / 2.0, H / 2.0
    np.savez(osp.join(root, "camera.npz"), fx=fx, fy=fy, cx=cx, cy=cy,
             quat=np.array([1.0, 0.0, 0.0, 0.0], np.float32),
             T=np.zeros(3, np.float32))
    poses = 0.03 * rng.standard_normal((n_frames, 24, 3)).astype(np.float32)
    trans = np.zeros((n_frames, 3), np.float32)
    trans[:, 0] = 0.15 * np.sin(np.linspace(0, 2 * np.pi, n_frames))
    trans[:, 2] = 2.5
    np.savez(osp.join(root, "smpl_rec.npz"), poses=poses, trans=trans,
             shape=np.zeros(10, np.float32), gender="neutral")
    yy, xx = np.mgrid[0:H, 0:W]
    for f in range(n_frames):
        pc = trans[f]
        col = cx - fx * pc[0] / pc[2]
        row = cy - fy * pc[1] / pc[2]
        r_pix = 0.35 * fx / pc[2]
        mask = ((xx - col) ** 2 + (yy - row) ** 2) < r_pix ** 2
        img = np.zeros((H, W, 3), np.uint8)
        img[mask] = (40 + 160 * (f / max(n_frames - 1, 1)), 90, 180)
        cv2.imwrite(osp.join(root, f"imgs/{f}.png"), img)
        cv2.imwrite(osp.join(root, f"masks/{f}.png"),
                    (mask * 255).astype(np.uint8))
    return root
