"""Data utilities (counterpart of thr3ed_atom_tpu/data/utils.py).

``get_image_transform`` flips and resizes an 8-bit image with the dataset's
own bilinear resize (``data/dataset.py`` ``resize_bilinear_uint8``, byte-equal
to PIL's), so the port needs no PIL; ``infinite_batches`` draws endless
(images, poses) batches from a dataset, uniformly with replacement, from a
``torch.Generator`` or from fed indices.
"""
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from thr3ed_atom_tpu_torch.data.dataset import resize_bilinear_uint8


def get_image_transform(new_size: Optional[Tuple[int, int]] = None,
                        flip_horizontal: bool = False):
    """A function of an 8-bit image ([H, W, C] uint8, or anything
    ``np.asarray`` makes one of, such as a PIL image) -> [H', W', C] float32 in
    [0, 1]: flipped left to right, then resized to ``new_size`` = (H', W')
    bilinearly as PIL's ``resize(BILINEAR)``."""

    def transform(image) -> np.ndarray:
        image = np.asarray(image)
        if flip_horizontal:
            image = image[:, ::-1]
        if new_size is not None and image.shape[:2] != tuple(new_size):
            squeeze = image.ndim == 2
            image = resize_bilinear_uint8(image[..., None] if squeeze else image,
                                          new_size[1], new_size[0])
            image = image[..., 0] if squeeze else image
        return np.asarray(image, dtype=np.float32) / 255.0

    return transform


def infinite_batches(generator: Optional[torch.Generator], dataset, batch_size: int,
                     indices: Optional[Iterable] = None
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (images [B, H, W, C], poses [B, 3, 4]) batches of a
    PosedImagesDataset, each view drawn uniformly with replacement: from
    ``generator`` (``torch.randint``), or the index arrays of ``indices`` in
    turn (ending with them)."""
    num = len(dataset)
    if indices is not None:
        for idx in indices:
            idx = np.asarray(idx)
            yield dataset.images[idx], dataset.poses[idx]
        return
    while True:
        idx = torch.randint(0, num, (batch_size,), generator=generator).numpy()
        yield dataset.images[idx], dataset.poses[idx]
