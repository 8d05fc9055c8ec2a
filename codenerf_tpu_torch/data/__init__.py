"""Datasets and host-side batch iteration (counterpart of
``codenerf_tpu/data``): the SRN, Blender and LLFF loaders on a
standard-library PNG decoder and a native baseline-JPEG decoder, the
seeded batch stream and the prefetching iterator."""

from codenerf_tpu_torch.data.loader import (  # noqa: F401
    BatchIterator, PrefetchIterator, build_dataset)
from codenerf_tpu_torch.data.png import read_png, write_png  # noqa: F401
from codenerf_tpu_torch.data.jpeg import read_jpeg, read_jpegs  # noqa: F401
from codenerf_tpu_torch.data.srn import SRNDataset  # noqa: F401
from codenerf_tpu_torch.data.blender import BlenderNeRFDataset  # noqa: F401
from codenerf_tpu_torch.data.llff import LLFFDataset  # noqa: F401
