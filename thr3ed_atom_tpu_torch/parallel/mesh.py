"""Device meshes over ``torch.distributed``: one process a device.

Counterpart of thr3ed_atom_tpu/parallel/mesh.py. The JAX package has one
controller over every device and expresses its meshes as shardings that XLA
turns into collectives; the port runs one process a device (each rank's
device is ``cuda:LOCAL_RANK``, or the CPU when the caller asks for it, as the
tests do) and writes its few collectives by hand:

  * ``"data"``: the ray batch, the tiles or the poses of a step split over
    ranks; every rank ends the step with the same reduced gradient;
  * ``"model"``: the voxel grid's x axis split into slabs (the ray-batch
    step), or the march's depth segments (the bricked step).

A 2-D mesh lays its ranks out as ``rank = d * model_parallel + m``. Only
``all_reduce``, ``all_gather`` and ``broadcast`` are used: both backends
(NCCL on the card, gloo on the CPU) carry them for CPU and CUDA tensors.
Nothing here falls back to one device: a mesh larger than the world raises.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given (a CUDA device without an
    index is this rank's card), else ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` as
    torchrun sets it; 0 when unset)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def init_process_group(backend: Optional[str] = None, device=None) -> bool:
    """Form the default process group unless one exists; returns True when
    this call formed it (the caller then destroys it). ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``, as torchrun sets them (with
    ``MASTER_ADDR`` / ``MASTER_PORT``), give the world; without them the
    group has one rank. The backend is NCCL on the card and gloo on the CPU
    unless ``backend`` names one; NCCL without CUDA raises."""
    if dist.is_initialized():
        return False
    dev = local_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_process_group: the NCCL backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


@dataclasses.dataclass
class Mesh:
    """A mesh of the first ``prod(shape)`` ranks of the default group, laid
    out row-major over ``axis_names`` (the last axis fastest). Building one
    is collective: every rank of the world calls it, members or not, in the
    same order. ``groups[axis]`` is this rank's group along the axis (None
    outside the mesh); ``coords`` its index along each axis."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    coords: Optional[Tuple[int, ...]]
    mesh_group: Optional[dist.ProcessGroup]

    @property
    def is_member(self) -> bool:
        return self.coords is not None

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: Optional[str] = None):
        """The group along ``axis`` (None: every rank of the mesh)."""
        return self.mesh_group if axis is None else self.groups[axis]


def _new_group(ranks: Sequence[int]):
    return dist.new_group(list(ranks))


def build_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over the first ranks of the default group; raises
    when the world is smaller or no group exists."""
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs an initialized process group "
                           "(parallel.mesh.init_process_group or torchrun)")
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} over axes {axis_names}")
    world, rank = dist.get_world_size(), dist.get_rank()
    size = 1
    for s in shape:
        size *= s
    if size > world:
        raise RuntimeError(f"a mesh of {shape} needs {size} ranks; the world has {world}")
    coords = None
    if rank < size:
        rest, c = rank, []
        for s in reversed(shape):
            c.append(rest % s)
            rest //= s
        coords = tuple(reversed(c))
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for a, name in enumerate(axis_names):
        groups[name] = None
        # every line of ranks along axis a, in a fixed order on every rank
        for base in range(size):
            if (base // strides[a]) % shape[a]:
                continue
            line = [base + i * strides[a] for i in range(shape[a])]
            g = _new_group(line)
            if rank in line:
                groups[name] = g
    mesh_group = _new_group(range(size))
    return Mesh(shape, axis_names, groups, coords, mesh_group if rank < size else None)


# meshes of the current default group, by (shape, axis names): a step that
# asks for its mesh every call makes its groups once
_MESHES: Dict[Tuple, Tuple[object, Mesh]] = {}


def _cached_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...]) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs an initialized process group "
                           "(parallel.mesh.init_process_group or torchrun)")
    world_group = dist.group.WORLD
    hit = _MESHES.get((shape, axis_names))
    if hit is not None and hit[0] is world_group:
        return hit[1]
    mesh = build_mesh(shape, axis_names)
    _MESHES[(shape, axis_names)] = (world_group, mesh)
    return mesh


def make_data_mesh(num_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over the first ``num_devices`` ranks (all when
    None)."""
    if not dist.is_initialized():
        raise RuntimeError("make_data_mesh needs an initialized process group")
    n = dist.get_world_size() if num_devices is None else int(num_devices)
    return _cached_mesh((n,), (DATA_AXIS,))


def make_grid_mesh(model_parallel: int, num_devices: Optional[int] = None) -> Mesh:
    """2-D ("data", "model") mesh: rays (or tiles) shard over "data", the
    voxel grid's x axis (or the march's depth segments) over "model";
    ``rank = d * model_parallel + m``."""
    if not dist.is_initialized():
        raise RuntimeError("make_grid_mesh needs an initialized process group")
    n = dist.get_world_size() if num_devices is None else int(num_devices)
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel {model_parallel}")
    return _cached_mesh((n // model_parallel, int(model_parallel)), (DATA_AXIS, MODEL_AXIS))


# ------------------------------------------------------------------ trees


def _map_tree(fn, tree):
    """``fn`` over the tensors of a tensor, tuple / list / NamedTuple / dict
    of them, or a VoxelGrid (a grid of the mapped densities and features
    with the same attributes); None and other leaves pass through."""
    from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid

    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, VoxelGrid):
        return VoxelGrid(fn(tree.densities.detach()), fn(tree.features.detach()),
                         voxel_size=tree.voxel_size, **tree.get_config_dict())
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return tree


def _shard_of(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Contiguous shard ``i`` of ``n`` along axis 0 (torch.tensor_split's:
    the first ``len % n`` shards one row longer)."""
    return torch.tensor_split(x, n, dim=0)[i]


def batch_sharding(mesh: Mesh):
    """The batch layout: axis 0 split over ``"data"`` (a function of a tree
    returning this rank's shard)."""
    return lambda tree: shard_batch(mesh, tree)


def replicated_sharding(mesh: Mesh):
    """The replicated layout (a function of a tree broadcasting it from the
    mesh's first rank)."""
    return lambda tree: replicate(mesh, tree)


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous slice of axis 0 of every tensor of ``tree``
    over ``"data"``; needs no communication (every rank holds the global
    batch)."""
    n, i = mesh.axis_size(DATA_AXIS), mesh.axis_index(DATA_AXIS)
    return _map_tree(lambda x: _shard_of(x, n, i), tree)


def replicate(mesh: Optional[Mesh], tree):
    """``tree``'s tensors broadcast in place from the mesh's first rank to
    every member (with no mesh, from rank 0 to the whole default group).
    Returns the tree."""
    group = None if mesh is None else mesh.group()

    def bcast(x):
        with torch.no_grad():
            dist.broadcast(x.data if isinstance(x, torch.nn.Parameter) else x, 0,
                           group=group)
        return x

    _walk(bcast, tree)
    return tree


def _walk(fn, tree) -> None:
    from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid

    if torch.is_tensor(tree):
        fn(tree)
    elif isinstance(tree, VoxelGrid):
        fn(tree.densities)
        fn(tree.features)
    elif isinstance(tree, dict):
        for v in tree.values():
            _walk(fn, v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _walk(fn, v)


def shard_grid_spatial(mesh: Mesh, tree):
    """This rank's x slab (axis 0) of every tensor of ``tree`` over
    ``"model"``: contiguous slabs, the first ``X % model_parallel`` one
    voxel thicker. A VoxelGrid comes back as a grid of its slab's tensors
    (the same voxel size and activations)."""
    n, i = mesh.axis_size(MODEL_AXIS), mesh.axis_index(MODEL_AXIS)
    return _map_tree(lambda x: _shard_of(x, n, i).clone(), tree)


def gather_grid_spatial(mesh: Mesh, tree, full_x: int):
    """Undo ``shard_grid_spatial``: every rank of a ``"model"`` line gathers
    the slabs of a tensor whose full x extent is ``full_x`` (no gradient
    flows through the gather)."""
    n = mesh.axis_size(MODEL_AXIS)
    group = mesh.group(MODEL_AXIS)
    sizes = [s.shape[0] for s in torch.tensor_split(torch.empty(full_x, 0), n)]
    rows = max(sizes)

    def gather(x):
        with torch.no_grad():
            x = x.detach()
            if x.shape[0] < rows:
                x = torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=group)
            return torch.cat([p[:s] for p, s in zip(parts, sizes)])

    return _map_tree(gather, tree)


# -------------------------------------------------------------- checks


def all_reduce_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each of ``tensors`` over ``group`` in place (every rank ends with
    the same bits: both backends hand every rank the one reduced result)."""
    for t in tensors:
        if t is not None:
            dist.all_reduce(t, group=group)


# words of one checksum chunk: its int64 temporaries stay at a few tens of MB
# whatever the grid's size
_CHECKSUM_CHUNK = 1 << 22


def _checksum(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Two int64 sums (wrapping) a tensor: of its words, and of its words
    times their 1-based position, taken a chunk of words at a time."""
    sums = []
    word = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    for t in tensors:
        words = t.detach().contiguous().view(-1).view(word[t.element_size()])
        plain = torch.zeros((), dtype=torch.int64, device=words.device)
        weighted = torch.zeros_like(plain)
        for start in range(0, words.numel(), _CHECKSUM_CHUNK):
            chunk = words[start:start + _CHECKSUM_CHUNK].to(torch.int64)
            pos = torch.arange(start + 1, start + 1 + chunk.numel(), device=words.device,
                               dtype=torch.int64)
            plain += chunk.sum()
            weighted += (chunk * pos).sum()
        sums += [plain, weighted]
    return torch.stack(sums)


def replicas_agree(tensors: Sequence[torch.Tensor], group=None) -> bool:
    """True when every rank of ``group`` holds bit-identical ``tensors``:
    their checksums (``_checksum``) compared through one all_reduce of the
    max and one of the min."""
    hi = _checksum(tensors)
    lo = -hi.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX, group=group)
    return bool(torch.equal(hi, -lo))
