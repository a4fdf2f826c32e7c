"""Build and load the package's CUDA kernels (csrc/*.cu) for Hopper.

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``build/kernels/`` at the
repository root, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads as built. Nothing is built when this module
is imported: ``load(name)`` builds one library on first use and
``build_all()`` starts one nvcc per source, all at once. ``bind`` returns a
library function with its ctypes signature set, bound once and cached, and
``stream`` the raw handle of PyTorch's current stream: the wrappers' launch
path does no more host work per call than the call itself needs.

There is no fallback: a missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

# one library per source; each lists the headers it includes (for the hash)
SOURCES: Dict[str, List[str]] = {
    "relu_trap": ["relu_trap.cu", "relu_trap.cuh"],
    "composite_fused": ["composite_fused.cu", "gnomonic_stage.cuh", "gnomonic_march.cuh",
                        "relu_trap.cuh", "smem_limit.cuh"],
    "composite_backward_fused": ["composite_backward_fused.cu", "gnomonic_stage.cuh",
                                 "gnomonic_march.cuh", "relu_trap.cuh", "smem_limit.cuh"],
    "composite_stripe": ["composite_stripe.cu", "gnomonic_stripe.cuh", "gnomonic_march.cuh",
                         "relu_trap.cuh", "smem_limit.cuh"],
    "composite_stripe_backward": ["composite_stripe_backward.cu", "gnomonic_stage.cuh",
                                  "gnomonic_stripe.cuh", "gnomonic_march.cuh", "relu_trap.cuh",
                                  "smem_limit.cuh"],
    "resample_rows": ["resample_rows.cu"],
    "slab_march": ["slab_march.cu", "slab_march.cuh"],
    "slab_march_backward": ["slab_march_backward.cu", "slab_march.cuh", "smem_limit.cuh"],
    "plane_march": ["plane_march.cu", "plane_march.cuh", "slab_march.cuh", "relu_trap.cuh"],
    "plane_march_backward": ["plane_march_backward.cu", "plane_march.cuh", "slab_march.cuh",
                             "relu_trap.cuh", "smem_limit.cuh"],
    "onehot_gather": ["onehot_gather.cu", "smem_limit.cuh"],
    "resample_rows_adjoint": ["resample_rows_adjoint.cu"],
}

# -fmad=false: no multiply-add contraction, so every f32 operation rounds where
# the plain PyTorch version (and the JAX reference) rounds — the affine tent
# positions feed bf16 roundings, where one contracted ulp can flip a bf16 ulp
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of thr3ed_atom_tpu_torch cannot be built"
        )
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.name, proc.tmp, proc.out = name, tmp, out
    return proc


def _finish_build(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {proc.name}:\n{log}")
    os.replace(proc.tmp, proc.out)
    return log


def build_all() -> Dict[str, str]:
    """Build every library that is not built yet, one nvcc per source, all
    started together. Returns {name: nvcc log} (ptxas registers/spills) for the
    libraries built by this call."""
    procs = [p for p in (_start_build(n) for n in SOURCES) if p is not None]
    logs = {}
    try:
        for p in procs:
            logs[p.name] = _finish_build(p)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        proc = _start_build(name)
        if proc is not None:
            _finish_build(proc)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def bind(name: str, fn_name: str, argtypes: Sequence, restype=ctypes.c_int):
    """Function ``fn_name`` of library ``name`` with its ``argtypes`` and
    ``restype`` set: bound on the first call (building the library if
    needed), then returned from a cache. Each pointer and the stream is a
    ``ctypes.c_void_p``, or ctypes passes it as a 32-bit int and cuts it."""
    fn = _bound.get((name, fn_name))
    if fn is None:
        fn = getattr(load(name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _bound[(name, fn_name)] = fn
    return fn


def stream(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s CUDA device,
    without building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")
