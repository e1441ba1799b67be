"""Host timing of the two frame decoders: the native loader
(``data/native_loader.py``) against cv2, on the synthetic subject's PNG
frames (image, mask and normal map per frame).

    python -m selfreconcode_tpu_torch.tools.time_frame_loader --root <dir> \\
        --device cpu

Renders (when absent) a 4-frame 1080x1080 subject and a 12-frame 512x512
subject under --root (the shapes of ``chip_smoke.py``'s phases 3b and 3;
--device renders them), then, --repeats times and alternating which
decoder goes first, times for each decoder: every 1080^2 frame decoded
alone by a fresh dataset (a cold N=1 load), and one epoch of the 512^2
subject in batches of 3 by a fresh dataset (the coarse stage's epoch-0
loads).  The files are in the page cache for both: "cold" means not yet in
the dataset's frame cache.  Prints each time and, as its last line, a JSON
object with the medians.  Needs the loader's toolchain (g++, png.h,
jpeglib.h).
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import statistics
import time

from ..data.dataset import SceneDataset
from ..data.native_loader import toolchain
from ..data.synthetic_subject import make_synthetic_subject

SUBJECTS = {"frame_1080": (4, 1080), "epoch_512": (12, 512)}


def subject(root: str, name: str, device: str) -> str:
    n, hw = SUBJECTS[name]
    path = osp.join(root, name)
    if not osp.isfile(osp.join(path, "smpl_rec.npz")):
        make_synthetic_subject(path, n_frames=n, H=hw, W=hw, device=device,
                               verbose=False)
    return path


def cold_frames(path: str, native: bool):
    """Seconds per frame, each decoded by a fresh dataset."""
    times = []
    n = SceneDataset(path, use_native=False).frame_num
    for fid in range(n):
        ds = SceneDataset(path, use_native=native)
        t0 = time.perf_counter()
        ds.batch_raw([fid])
        times.append(time.perf_counter() - t0)
    return times


def epoch(path: str, native: bool, batch: int = 3) -> float:
    """Seconds to decode every frame once, `batch` frames a call."""
    ds = SceneDataset(path, use_native=native)
    t0 = time.perf_counter()
    for i in range(0, ds.frame_num, batch):
        ds.batch_raw(list(range(i, min(i + batch, ds.frame_num))))
    return time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--device", default="cuda",
                   help="renders the subjects (default cuda)")
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    missing = toolchain()
    if missing:
        raise SystemExit(f"the native loader cannot build here: {missing}")
    os.makedirs(args.root, exist_ok=True)
    frame_path = subject(args.root, "frame_1080", args.device)
    epoch_path = subject(args.root, "epoch_512", args.device)
    SceneDataset(frame_path).batch_raw([0])      # builds the loader
    res = {f"{what}_{dec}": [] for what in SUBJECTS
           for dec in ("native", "cv2")}
    for r in range(args.repeats):
        order = (True, False) if r % 2 == 0 else (False, True)
        for native in order:
            dec = "native" if native else "cv2"
            res[f"frame_1080_{dec}"] += cold_frames(frame_path, native)
            res[f"epoch_512_{dec}"].append(epoch(epoch_path, native))
    for k, v in res.items():
        print(f"{k}: {[round(t, 5) for t in v]} s", flush=True)
    print(json.dumps({k: statistics.median(v) for k, v in res.items()}))


if __name__ == "__main__":
    main()
