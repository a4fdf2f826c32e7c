"""3inFusion: a 3-D diffusion model over voxel-grid crops of a reconstructed
scene (counterpart of thr3ed_atom_tpu/diffusion/)."""
