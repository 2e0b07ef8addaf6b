"""The ranks' layout over named axes, and the collectives along them.

Counterpart of ``audio_to_midi_tpu/parallel/mesh.py``.  JAX lays devices
out in a ``jax.sharding.Mesh`` and lets GSPMD insert the collectives; the
port runs one process per rank (``torch.distributed``) and calls them itself:

  * :func:`initialize_multihost` joins the process group (a no-op for one
    process, as in JAX);
  * :func:`make_mesh` lays the world's ranks out as
    ``("ensemble", "data"[, "model"])``, model innermost, by JAX's rules and
    with its error and warning texts; the :class:`Mesh` holds this rank's
    coordinates and one process group per axis longer than 1;
  * the collectives are ``all_reduce``, ``all_gather`` and a barrier, along
    an axis or over the whole world (``axis=None``).  ``all_gather``
    is an ``all_reduce`` of a zero-padded buffer of the tensor's bits, as
    integers, on every backend alike: gloo, which runs ranks that share one
    card, does not take every gather on CUDA tensors, and an integer sum with
    zeros gives the bits back exactly (a float sum would turn -0.0 into 0.0).

With one process the mesh is ``(1, 1[, 1])``, holds no group, and no
collective is issued: every caller keeps its single-process path.

The placement rules of JAX's ``batch_spec``, ``shard_params`` and
``make_param_placer`` become :func:`local_minibatches` (this rank's ``"data"``
slice of each minibatch) and :func:`place_model` (replicated, one member
per ensemble index, or tensor-parallel shards through :mod:`.tp`).
"""

from __future__ import annotations

import math
import warnings
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
ENSEMBLE_AXIS = "ensemble"
MODEL_AXIS = "model"

DEFAULT_TIMEOUT = timedelta(minutes=10)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the process group of ``num_processes`` ranks at
    ``coordinator_address`` (``host:port``), as rank ``process_id``; a
    no-op for ``num_processes`` None or 1.  ``backend`` None: ``"nccl"``
    where CUDA is available, else ``"gloo"``."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("multi-process training needs --coordinator-address and --process-id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=timeout)


def world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:{rank % device_count}`` for ``"cuda"``."""
    if device_type != "cuda":
        return torch.device(device_type)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available")
    return torch.device("cuda", world()[0] % torch.cuda.device_count())


def build_kernels_once(mesh: "Mesh") -> None:
    """Rank 0 builds the CUDA kernels while the others wait at a barrier,
    so that N ranks do not each start the compilers; then every rank loads
    the library."""
    from ..ops import cuda_build

    if mesh.rank == 0:
        cuda_build.build()
    mesh.barrier()


def mesh_layout(ensemble_size: int, n: int, model_size: int = 1) -> tuple[tuple, tuple]:
    """JAX's ``make_mesh`` rules on ``n`` ranks -> (axis names, shape).
    ``model_size`` that does not divide ``n`` raises; ``ensemble_size`` that
    does not divide falls back to 1 with a warning."""
    if model_size > 1 and n % model_size:
        raise ValueError(
            f"model_parallel_size {model_size} does not divide the "
            f"{n}-device count; pick a divisor or drop the model axis"
        )
    if model_size > 1:
        axes: tuple = (ENSEMBLE_AXIS, DATA_AXIS, MODEL_AXIS)
        n_groups = n // model_size
        e = ensemble_size if ensemble_size > 1 and n_groups % ensemble_size == 0 else 1
        if e != ensemble_size and ensemble_size > 1:
            warnings.warn(
                f"ensemble_size {ensemble_size} does not divide the "
                f"{n_groups} data groups; using ensemble axis of 1",
                stacklevel=3,
            )
        return axes, (e, n_groups // e, model_size)
    if ensemble_size > 1 and n % ensemble_size == 0:
        return (ENSEMBLE_AXIS, DATA_AXIS), (ensemble_size, n // ensemble_size)
    if ensemble_size > 1:
        warnings.warn(
            f"ensemble_size {ensemble_size} does not divide the "
            f"{n}-device count; using ensemble axis of 1",
            stacklevel=3,
        )
    return (ENSEMBLE_AXIS, DATA_AXIS), (1, n)


def _int_bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as an integer tensor that sums exactly with zeros."""
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    size = t.element_size()
    if size == 8:
        return t.view(torch.int64)
    if size == 4:
        return t.view(torch.int32)
    if size == 2:
        return t.view(torch.int16).to(torch.int32)
    return t.view(torch.uint8).to(torch.int32)


def _from_int_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return bits != 0
    size = torch.empty((), dtype=dtype).element_size()
    if size in (8, 4):
        return bits.view(dtype)
    if size == 2:
        return bits.to(torch.int16).view(dtype)
    return bits.to(torch.uint8).view(dtype)


class Mesh:
    """The world's ranks on named axes, row-major, the last axis innermost.

    ``shape`` maps each axis to its extent, as JAX's ``mesh.shape``;
    ``coords`` this rank's index on each.  A process group is built for
    every axis longer than 1 (every rank builds every group, in the same
    order: ``new_group`` is collective)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], rank: int = 0,
                 build_groups: bool = True):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(rank, tuple(shape)))))
        self._groups: dict[str, object] = {}
        if build_groups and self.size > 1:
            ranks = np.arange(self.size).reshape(tuple(shape))
            for i, axis in enumerate(self.axis_names):
                extent = self.shape[axis]
                if extent == 1:
                    continue
                for row in np.moveaxis(ranks, i, -1).reshape(-1, extent).tolist():
                    group = dist.new_group(row)
                    if rank in row:
                        self._groups[axis] = group

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"

    def __deepcopy__(self, memo):
        return self  # process groups are not copied

    def extent(self, axis: Optional[str]) -> int:
        """The number of ranks along ``axis`` (None: the world)."""
        return self.size if axis is None else self.shape.get(axis, 1)

    def index(self, axis: Optional[str]) -> int:
        """This rank's index along ``axis`` (None: its rank)."""
        return self.rank if axis is None else self.coords.get(axis, 0)

    def group(self, axis: Optional[str]):
        return None if axis is None else self._groups[axis]

    def _on_backend(self, t: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        """``t`` where the axis's backend takes it: NCCL takes CUDA tensors
        only, so a host tensor goes to this rank's card and back."""
        if t.device.type == "cpu" and dist.get_backend(self.group(axis)) == "nccl":
            return t.to(rank_device("cuda"))
        return t

    def all_reduce_(self, t: torch.Tensor, axis: Optional[str],
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced in place over the ranks along ``axis``."""
        if self.extent(axis) > 1:
            on = self._on_backend(t, axis)
            dist.all_reduce(on, op=op, group=self.group(axis))
            if on is not t:
                t.copy_(on)
        return t

    def all_gather(self, t: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        """(n, *t.shape): every rank's ``t`` along ``axis``, in index order,
        bit for bit."""
        n = self.extent(axis)
        if n == 1:
            return t[None]
        bits = self._on_backend(_int_bits(t.contiguous()), axis)
        buf = torch.zeros((n, *bits.shape), dtype=bits.dtype, device=bits.device)
        buf[self.index(axis)] = bits
        dist.all_reduce(buf, group=self.group(axis))
        return _from_int_bits(buf.to(t.device), t.dtype)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def same_across(self, value: int, axis: Optional[str]) -> bool:
        """Whether every rank along ``axis`` holds the same int64 ``value``."""
        if self.extent(axis) == 1:
            return True
        t = torch.tensor([value, -value], dtype=torch.int64)
        self.all_reduce_(t, axis, op=dist.ReduceOp.MAX)
        return int(t[0]) == value and -int(t[1]) == value


def make_mesh(
    ensemble_size: int = 1,
    world_size: Optional[int] = None,
    model_size: int = 1,
    rank: Optional[int] = None,
) -> Mesh:
    """("ensemble", "data"[, "model"]) over the world's ranks (or
    ``world_size`` ranks, laid out without process groups when no group is
    initialized: the rules alone).  ``model_size`` > 1 appends a
    tensor-parallel axis, innermost; see :func:`mesh_layout`."""
    r, w = world()
    n = w if world_size is None else world_size
    axes, shape = mesh_layout(ensemble_size, n, model_size)
    live = dist.is_available() and dist.is_initialized() and n == w
    return Mesh(axes, shape, r if rank is None else rank, build_groups=live)


def tp_active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.extent(MODEL_AXIS) > 1


def local_minibatches(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(num_minibatches, minibatch, ...) -> this rank's ``"data"`` slice of
    every minibatch (JAX's ``batch_spec(mesh, 1)``)."""
    if mesh is None or mesh.extent(DATA_AXIS) == 1:
        return x
    n = mesh.extent(DATA_AXIS)
    if x.shape[1] % n:
        raise ValueError(f"minibatch {x.shape[1]} does not divide over {n} data ranks")
    per = x.shape[1] // n
    d = mesh.index(DATA_AXIS)
    return x[:, d * per:(d + 1) * per]


def param_digest(tensors: Sequence[torch.Tensor]) -> int:
    """A position-weighted sum of the tensors' bits (int64, wrapping): equal
    bits give equal digests."""
    total = 0
    for i, t in enumerate(tensors):
        bits = _int_bits(t.detach().contiguous()).reshape(-1).to(torch.int64)
        weights = torch.arange(bits.numel(), dtype=torch.int64, device=bits.device) % 65521 + 1
        total = (total * 1_000_003 + int((bits * weights).sum()) + i) & 0x7FFF_FFFF_FFFF_FFFF
    return total


def place_model(model, mesh: Mesh, num_heads: int):
    """This rank's part of ``model`` (a ``Model``, or an ``Ensemble`` of
    ``cfg.train.ensemble_size``), built from the same seed on every rank:
    the member at this rank's ensemble index when the ensemble axis is
    longer than 1, tensor-parallel shards when the model axis is (see
    :mod:`.tp`), else the model itself.  Checks that the replicated
    parameters are the same on every rank."""
    from ..models.model import Ensemble
    from .tp import shard_params_tp

    e = mesh.extent(ENSEMBLE_AXIS)
    if e > 1:
        if not isinstance(model, Ensemble) or len(model) != e:
            raise ValueError(f"an ensemble axis of {e} takes an Ensemble of {e} members")
        model = model[mesh.index(ENSEMBLE_AXIS)]
    if tp_active(mesh):
        shard_params_tp(model, mesh, num_heads)
    check_replicated(model, mesh)
    return model


def replicated_params(model) -> list[torch.Tensor]:
    """The parameters that every rank of a data group and of a model group
    holds whole (every one but the tensor-parallel shards)."""
    tp = getattr(model, "tp", None)
    sharded = tp.sharded if tp is not None else frozenset()
    return [p for name, p in model.named_parameters() if name not in sharded]


def check_replicated(model, mesh: Mesh) -> None:
    """Raise unless every rank along ``"data"`` holds the same parameters and
    every rank along ``"model"`` the same replicated ones."""
    if mesh.size == 1:
        return
    if not mesh.same_across(param_digest(list(model.parameters())), DATA_AXIS):
        raise RuntimeError("the parameters differ across the data ranks")
    if not mesh.same_across(param_digest(replicated_params(model)), MODEL_AXIS):
        raise RuntimeError("the replicated parameters differ across the model ranks")


def gather_params(model, mesh: Mesh) -> dict[str, np.ndarray]:
    """The full JAX layout of what the ranks hold, on every rank: a
    ``Model``'s flat parameters, or the population's with its leading
    ``(E,)`` axis (members gathered over ``"ensemble"``, shards over
    ``"model"``).  A collective: every rank calls it."""
    from .tp import gather_flat

    flat = gather_flat(model)
    if mesh.extent(ENSEMBLE_AXIS) == 1:
        return flat
    return {path: mesh.all_gather(torch.from_numpy(np.ascontiguousarray(v)),
                                  ENSEMBLE_AXIS).numpy() for path, v in flat.items()}
