"""PeopleSnapshot preprocessing (copy of the JAX package's
cli/people_snapshot.py; parity with the reference's
people_snapshot_process.py).

    python -m selfreconcode_tpu_torch.cli.people_snapshot --root <subject> \\
        --save_root <scene>

Converts a people_snapshot_public subject directory into the on-disk layout
SceneDataset consumes: imgs/ masks/ camera.npz smpl_rec.npz.  Torch-free
(h5py + cv2 only, like the data itself requires).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
from glob import glob

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="people_snapshot preprocess")
    parser.add_argument("--root", default=None, help="subject dir")
    parser.add_argument("--sid", default=0, type=int,
                        help="start frame index")
    parser.add_argument("--save_root", default=None)
    args = parser.parse_args(argv)

    import cv2
    import h5py

    root, sid, save_root = args.root, args.sid, args.save_root
    # gender from the subject path (JAX :30-35)
    if "female" in root:
        gender = "female"
    elif "male" in root:
        gender = "male"
    else:
        raise SystemExit("cannot infer gender from path " + root)
    os.makedirs(save_root, exist_ok=True)

    # masks from frame sid on, as %06d.png (JAX :38-46)
    with h5py.File(osp.join(root, "masks.hdf5"), "r") as ff:
        fnum = ff["masks"].shape[0]
        assert fnum > sid
        mask_root = osp.join(save_root, "masks")
        os.makedirs(mask_root, exist_ok=True)
        for ind in range(sid, fnum):
            cv2.imwrite(osp.join(mask_root, "%06d.png" % (ind - sid)),
                        ff["masks"][ind] * 255)
    print(f"masks: {fnum - sid}")

    # the one video's frames from sid on (JAX :48-65)
    videos = glob(osp.join(root, "*.mp4"))
    assert len(videos) == 1, videos
    cap = cv2.VideoCapture(videos[0])
    rgb_root = osp.join(save_root, "imgs")
    os.makedirs(rgb_root, exist_ok=True)
    for ind in range(fnum):
        check, img = cap.read()
        if not check:
            break
        if ind < sid:
            continue
        if img.shape[:2] == (1080, 1920):
            # portrait video stored landscape (people_snapshot quirk,
            # people_snapshot_process.py:54-56)
            img = img.transpose(1, 0, 2)
            img = img[:, ::-1, :]
        cv2.imwrite(osp.join(rgb_root, "%06d.png" % (ind - sid)), img)
    cap.release()
    print("rgbs done")

    # camera.npz from camera.pkl (JAX :68-79)
    with open(osp.join(root, "camera.pkl"), "rb") as ff:
        cam = pickle.load(ff, encoding="latin1")
        rt = cam["camera_rt"]
        assert np.linalg.norm(rt) < 1e-4, (
            "snapshot cameras are expected to have no rotation")
        # the fixed quaternion encodes the VideoAvatar->our convention flip
        # (people_snapshot_process.py:72)
        quat = np.array([np.cos(np.pi / 2.0), 0.0, 0.0, np.sin(np.pi / 2.0)])
        np.savez(osp.join(save_root, "camera.npz"),
                 fx=cam["camera_f"][0], fy=cam["camera_f"][1],
                 cx=cam["camera_c"][0], cy=cam["camera_c"][1],
                 quat=quat, T=cam["camera_t"])

    # smpl_rec.npz from frame sid on (JAX :81-87)
    with h5py.File(osp.join(root, "reconstructed_poses.hdf5"), "r") as ff:
        shape = ff["betas"][:].reshape(10)
        poses = ff["pose"][:].reshape(-1, 24, 3)[sid:, :, :]
        trans = ff["trans"][:].reshape(-1, 3)[sid:, :]
        assert poses.shape[0] >= fnum - sid and trans.shape[0] >= fnum - sid
        np.savez(osp.join(save_root, "smpl_rec.npz"), poses=poses,
                 shape=shape, trans=trans, gender=gender)
    print("camera.npz + smpl_rec.npz written ->", save_root)


if __name__ == "__main__":
    main()
