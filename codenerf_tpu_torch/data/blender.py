"""Blender (nerf_synthetic) dataset (counterpart of
``codenerf_tpu/data/blender.py``), the loader of ``configs/lego.yml``:

    <basedir>/transforms_{train,val,test}.json
    <basedir>/<file_path>.png   (RGBA)

Images are read by ``png.read_png`` in place of imageio.  As in the JAX
package: an integer ``resolution_level`` box-filter downsample, the focal
from ``camera_angle_x`` at the downsampled width, the principal point at
the image centre, ``color`` with every channel the PNG has (the alpha
kept, not composited: the losses and PSNR read ``[..., :3]``), the mask
from the alpha, object id 0 (one scene).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from codenerf_tpu_torch.data.png import read_png


def box_downsample(img: np.ndarray, r: int) -> np.ndarray:
    """[H, W, C] averaged over r x r blocks (rows and columns past the
    last whole block dropped), as the JAX loaders downsample."""
    if r <= 1:
        return img
    h, w = img.shape[0] // r * r, img.shape[1] // r * r
    return img[:h, :w].reshape(h // r, r, w // r, r, -1).mean(axis=(1, 3))


def centred_intrinsic(focal: float, height: int, width: int) -> np.ndarray:
    """4x4 intrinsic with ``focal`` and the principal point at the centre."""
    intrinsic = np.eye(4, dtype=np.float32)
    intrinsic[0, 0] = intrinsic[1, 1] = focal
    intrinsic[0, 2], intrinsic[1, 2] = width / 2.0, height / 2.0
    return intrinsic


class BlenderNeRFDataset:
    def __init__(self, path: str, stage: str = "train",
                 resolution_level: int = 1):
        self.base_path = Path(path)
        self.stage = stage
        self.resolution_level = max(1, int(resolution_level))
        meta_path = self.base_path / f"transforms_{stage}.json"
        if not meta_path.exists():
            raise FileNotFoundError(f"{meta_path} does not exist")
        with open(meta_path) as f:
            self.meta = json.load(f)
        self.frames = self.meta["frames"]
        self.camera_angle_x = float(self.meta["camera_angle_x"])
        self.num_objects = 1
        self.num_views = len(self.frames)

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, index: int) -> dict:
        frame = self.frames[index]
        img = read_png(self.base_path / (frame["file_path"] + ".png"))
        img = box_downsample(img.astype(np.float32) / 255.0,
                             self.resolution_level)
        height, width = img.shape[:2]
        focal = 0.5 * width / np.tan(0.5 * self.camera_angle_x)
        mask = (img[..., 3:4].copy() if img.shape[-1] == 4
                else np.ones_like(img[..., :1]))
        return {
            "object_id": np.int32(0),
            "intrinsic": centred_intrinsic(focal, height, width),
            "color": img.astype(np.float32),
            "mask": mask.astype(np.float32),
            "pose": np.asarray(frame["transform_matrix"], dtype=np.float32),
        }
