"""SRN (Scene Representation Networks) dataset (counterpart of
``codenerf_tpu/data/srn.py``; reference view_synthesis/datasets/
dataset.py:10-94).

A host-side numpy pipeline, as in the JAX package, with ``png.read_png``
in place of imageio.  Every reference quirk is kept, because it shapes
the learned distribution:

  * objects enumerated by a sorted glob of ``*/intrinsics.txt``;
  * the chairs train split prefers its ``chairs_2.0_train`` subdir;
  * mask = all channels != 255;
  * the crop of height // 8 and width // 8 per side, written as
    ``rgb[cw:width - cw, ch:height - ch]`` (rows by the width margins,
    as the reference writes it);
  * pose @ diag(1, -1, -1, 1), the OpenGL -> OpenCV flip;
  * a 4x4 intrinsic with the crop-adjusted cx, cy.

``load_views`` decodes a batch through the native loader
(``data/native.py``: threaded C++ on zlib) when it builds and the first
view's PNG header matches the split's height and width, as the JAX
package's does; otherwise it stacks the per-item path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from codenerf_tpu_torch.data import native
from codenerf_tpu_torch.data.png import read_png


def _read_rgb(path) -> np.ndarray:
    """``read_png`` in imageio's shape: greyscale as [H, W]."""
    img = read_png(path)
    return img[..., 0] if img.shape[-1] == 1 else img


class SRNDataset:
    def __init__(self, path: str, stage: str = "train",
                 use_native: bool = True):
        self.base_path = Path(path)
        self.dataset_name = self.base_path.stem.split("_")[-1]
        self.base_path = self.base_path / f"{self.dataset_name}_{stage}"
        self.stage = stage
        if not self.base_path.exists():
            raise FileNotFoundError(f"{self.base_path} does not exist")

        if "chair" in self.dataset_name and stage == "train":
            alt = self.base_path / "chairs_2.0_train"
            if alt.exists():
                self.base_path = alt

        self.intrinsic_files = sorted(self.base_path.glob("*/intrinsics.txt"))
        self.num_objects = len(self.intrinsic_files)

        self.rgb_files = []
        self.pose_files = []
        for index, intrinsic_path in enumerate(self.intrinsic_files):
            rgb_dir = intrinsic_path.parent / "rgb"
            pose_dir = intrinsic_path.parent / "pose"
            self.rgb_files.extend(sorted((index, p)
                                         for p in rgb_dir.iterdir()))
            self.pose_files.extend(sorted((index, p)
                                          for p in pose_dir.iterdir()))
        if len(self.rgb_files) != len(self.pose_files):
            raise ValueError(f"{self.base_path}: {len(self.rgb_files)} "
                             f"images but {len(self.pose_files)} poses")
        self.num_views = (len(self.rgb_files) // self.num_objects
                          if self.num_objects else 0)
        self._homogeneous = None
        self.use_native = use_native

    def _read_intrinsics(self, object_index: int):
        with open(self.intrinsic_files[object_index]) as f:
            lines = f.readlines()
            focal, cx, cy, _ = map(float, lines[0].split())
            height, width = map(int, lines[-1].split())
        return focal, cx, cy, height, width

    def intrinsics_homogeneous(self, rtol: float = 1e-5) -> bool:
        """True when every object's intrinsics.txt agrees with the first.

        The harness builds one pixel-direction grid from one probe, as the
        reference does (train.py:51-52), so it refuses a split whose
        objects carry different intrinsics.  Cached after the first call.
        """
        if self._homogeneous is None:
            vals = [self._read_intrinsics(i) for i in range(self.num_objects)]
            self._homogeneous = all(np.allclose(v, vals[0], rtol=rtol)
                                    for v in vals[1:])
        return self._homogeneous

    def _meta_for(self, index: int):
        """(object_id, intrinsic, pose, height, width): everything but the
        pixels."""
        object_index, _ = self.rgb_files[index]
        _, pose_filename = self.pose_files[index]
        focal, cx, cy, height, width = self._read_intrinsics(object_index)
        ch, cw = height // 8, width // 8
        pose = np.loadtxt(pose_filename).reshape(4, 4)
        pose = pose @ np.diag([1.0, -1.0, -1.0, 1.0])
        intrinsic = np.eye(4)
        intrinsic[0, 0] = intrinsic[1, 1] = focal
        intrinsic[0, 2], intrinsic[1, 2] = cx - cw, cy - ch
        return (np.int32(object_index), intrinsic.astype(np.float32),
                pose.astype(np.float32), height, width)

    def load_views(self, indices, num_threads: int = 8) -> dict:
        """The samples at ``indices``, stacked: decoded by the native
        loader when it is available and the first view's header matches
        the split's height and width, else item by item."""
        indices = [int(i) for i in indices]
        if self.use_native and indices and native.available():
            metas = [self._meta_for(i) for i in indices]
            height, width = metas[0][3], metas[0][4]
            probe = native.probe(self.rgb_files[indices[0]][1])
            if probe is not None and probe[:2] == (height, width):
                colors, masks = native.load_batch(
                    [self.rgb_files[i][1] for i in indices], height, width,
                    probe[2], num_threads)
                native.record("native")
                return {"object_id": np.stack([m[0] for m in metas]),
                        "intrinsic": np.stack([m[1] for m in metas]),
                        "color": colors, "mask": masks,
                        "pose": np.stack([m[2] for m in metas])}
        native.record("python")
        samples = [self[i] for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def __len__(self):
        return len(self.rgb_files)

    def __getitem__(self, index: int) -> dict:
        object_id, intrinsic, pose, height, width = self._meta_for(index)
        rgb = _read_rgb(self.rgb_files[index][1])
        mask = (rgb != 255).all(axis=-1)[..., None].astype(np.float32)
        rgb = rgb.astype(np.float32) / 255.0

        ch, cw = height // 8, width // 8
        rgb = rgb[cw:width - cw, ch:height - ch, ...]
        mask = mask[cw:width - cw, ch:height - ch, ...]
        return {
            "object_id": object_id,
            "intrinsic": intrinsic,
            "color": rgb.astype(np.float32),
            "mask": mask,
            "pose": pose,
        }
