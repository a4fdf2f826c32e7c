"""PyTorch/CUDA port of thr3ed_atom_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module paths and public names; the kernels the JAX
package writes in Pallas are CUDA C++ sources under ``csrc/``, built with nvcc
at first use (``thr3ed_atom_tpu_torch.kernels``). Entry points run on the
``"cuda"`` device unless the caller passes ``device="cpu"``; on CPU tensors each
kernel wrapper runs its plain PyTorch version instead.
"""
