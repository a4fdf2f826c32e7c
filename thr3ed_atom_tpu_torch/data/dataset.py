"""Posed-image datasets (counterpart of thr3ed_atom_tpu/data/dataset.py).

Not ported yet: the JAX package reads its images as PNGs through PIL, and the
machine with the card is not known to have PIL. The train step takes images,
rotations and origins as tensors meanwhile
(rendering/gnomonic_train.py gnomonic_train_step_multi).
"""
from __future__ import annotations


class PosedImagesDataset:
    """Not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "data/dataset.py (posed images read through PIL) is not ported yet "
            "(ROADMAP.md, 'Modules to port', item 5: the next slice with the "
            "stage loop and apps/train_sh_voxel_grid.py)"
        )
