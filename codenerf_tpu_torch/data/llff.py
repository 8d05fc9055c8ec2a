"""LLFF (forward-facing, e.g. fern) dataset (counterpart of
``codenerf_tpu/data/llff.py``), the loader of ``configs/fern.yml``:

    <basedir>/poses_bounds.npy   [N, 17]: 3x5 pose (c2w | hwf) + 2 bounds
    <basedir>/images_<factor>/*.{png,jpg}, else <basedir>/images/*.{png,jpg}

As in the JAX package: the poses' [down right back] columns become
[right up back], the poses are recentred on their mean, ``images_<factor>``
is read when it exists and ``images/`` box-downsampled by the factor in
memory otherwise, the focal scales with the width, and every
``llffhold``-th view is the val split.  ``.png`` / ``.PNG`` files are read
by ``png.read_png``, ``.jpg`` / ``.jpeg`` / ``.JPG`` (LLFF's full-size
``images/``) by ``jpeg.read_jpeg``, both bit-equal to the JAX package's
``imageio.imread``.  A split read from ``images/`` with the in-memory
downsample is decoded once, at construction (its JPEGs on threads), and
its downsampled views are served from memory: a full-size fern view is
12 Mpixel.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from codenerf_tpu_torch.data.blender import box_downsample, centred_intrinsic
from codenerf_tpu_torch.data.jpeg import read_jpeg, read_jpegs
from codenerf_tpu_torch.data.png import read_png

_EXTS = {".png", ".jpg", ".jpeg", ".JPG", ".PNG"}
_JPEG = {".jpg", ".jpeg", ".JPG"}
# views decoded together while the split's views are cached
_DECODE_THREADS = 8


def _read(path: Path) -> np.ndarray:
    """uint8 pixels of one image, as ``imageio.imread`` reads them."""
    return read_jpeg(path) if path.suffix in _JPEG else read_png(path)


def _view(img: np.ndarray, r: int) -> np.ndarray:
    """The float32 view the JAX loader makes of ``img``: /255, then
    box-downsampled by ``r``."""
    return box_downsample(img.astype(np.float32) / 255.0, r)


def _recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Rigidly transform [N, 4, 4] poses so that their average is the
    identity (JAX ``_recenter_poses``)."""
    def viewmatrix(z, up, pos):
        vec2 = z / np.linalg.norm(z)
        vec0 = np.cross(up, vec2)
        vec0 = vec0 / np.linalg.norm(vec0)
        vec1 = np.cross(vec2, vec0)
        return np.stack([vec0, vec1, vec2, pos], axis=1)

    center = poses[:, :3, 3].mean(0)
    vec2 = poses[:, :3, 2].sum(0)
    up = poses[:, :3, 1].sum(0)
    c2w = np.concatenate([viewmatrix(vec2, up, center),
                          np.array([[0, 0, 0, 1.0]])], axis=0)
    return np.linalg.inv(c2w) @ poses


class LLFFDataset:
    def __init__(self, path: str, stage: str = "train",
                 downsample_factor: int = 8, llffhold: int = 8):
        self.base_path = Path(path)
        self.stage = stage
        if not self.base_path.exists():
            raise FileNotFoundError(f"{self.base_path} does not exist")
        pb = np.load(self.base_path / "poses_bounds.npy")       # [N, 17]
        poses_hwf = pb[:, :15].reshape(-1, 3, 5)
        self.bounds = pb[:, 15:17]

        img_dir = self.base_path / f"images_{downsample_factor}"
        self._mem_downsample = 1
        if not img_dir.exists():
            img_dir = self.base_path / "images"
            self._mem_downsample = max(1, int(downsample_factor))
        files = sorted(p for p in img_dir.iterdir() if p.suffix in _EXTS)
        if len(files) != pb.shape[0]:
            raise ValueError(f"{img_dir}: {len(files)} images against "
                             f"{pb.shape[0]} poses")

        # [down right back] -> [right up back]
        poses = np.concatenate([poses_hwf[:, :, 1:2], -poses_hwf[:, :, 0:1],
                                poses_hwf[:, :, 2:4]], axis=-1)
        bottom = np.tile(np.array([[[0, 0, 0, 1.0]]]), (poses.shape[0], 1, 1))
        poses = _recenter_poses(np.concatenate([poses, bottom], axis=1))
        self.hwf = poses_hwf[:, :, 4]      # [N, 3]: H, W, focal at full size

        hold = max(1, int(llffhold))
        idx = np.arange(pb.shape[0])
        sel = idx[::hold] if stage in ("val", "test") else idx[idx % hold != 0]
        self.files = [files[i] for i in sel]
        self._views = (self._decode_views() if self._mem_downsample > 1
                       else None)
        self.poses = poses[sel].astype(np.float32)
        self.sel_hwf = self.hwf[sel]
        self.num_objects = 1
        self.num_views = len(self.files)

    def _decode_views(self) -> list:
        """Every view of the split, decoded and downsampled: JPEGs through
        ``read_jpegs``, ``_DECODE_THREADS`` files at a time."""
        r = self._mem_downsample
        views = [None] * len(self.files)
        with ThreadPoolExecutor(_DECODE_THREADS) as pool:
            for start in range(0, len(self.files), _DECODE_THREADS):
                idx = range(start, min(start + _DECODE_THREADS,
                                       len(self.files)))
                jpeg = [i for i in idx if self.files[i].suffix in _JPEG]
                imgs = dict(zip(jpeg, read_jpegs(
                    [self.files[i] for i in jpeg], _DECODE_THREADS)))
                for i in idx:
                    if i not in imgs:
                        imgs[i] = read_png(self.files[i])
                for i, view in zip(idx, pool.map(lambda i: _view(imgs[i], r),
                                                 idx)):
                    views[i] = view
        return views

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int) -> dict:
        img = (self._views[index].copy() if self._views is not None
               else _view(_read(self.files[index]), self._mem_downsample))
        height, width = img.shape[:2]
        _, w0, f0 = self.sel_hwf[index]
        focal = float(f0) * width / float(w0)
        return {
            "object_id": np.int32(0),
            "intrinsic": centred_intrinsic(focal, height, width),
            "color": img,
            "mask": np.ones_like(img[..., :1], dtype=np.float32),
            "pose": self.poses[index],
        }

    def load_views(self, indices) -> dict:
        """The samples at ``indices`` stacked, as ``BatchIterator`` asks
        for them."""
        samples = [self[int(i)] for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
