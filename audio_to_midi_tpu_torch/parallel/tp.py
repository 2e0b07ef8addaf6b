"""Tensor (model) parallelism: Megatron sharding over the ``"model"`` axis.

Counterpart of ``audio_to_midi_tpu/parallel/tp.py``.  JAX places the
weights with NamedShardings and lets GSPMD insert the collectives; here each
rank holds its slices of the sharded weights and the model calls the two
Megatron functions itself:

  * :func:`copy_to_model` -- identity forward, ``all_reduce`` over
    ``"model"`` backward -- where a replicated activation enters a sharded
    product: the attention block's normed input to ``q_up``, ``kv_down``'s
    output to ``k_up`` and ``v_up`` (``kv_down`` is replicated, so its
    weight gradient and its share of the input's come out whole on every
    rank once the gradient of its output is), and the FFN's normed input;
  * :func:`reduce_from_model` -- ``all_reduce`` forward, identity backward --
    after the row-split products ``attention/out`` and ``ff/out_proj``.
The sums run in f32 and are cast back to the activations' dtype.

The rules, over the JAX leaf paths (``convert.state_dict_to_jax``) and the
port's parameter names alike (JAX's ``_tp_dim`` and ``_leaf_spec``):

  * ``attention/{q_up,k_up,v_up}/w`` -- split the output (head) dim, whole
    heads only (``H % model_size``);
  * ``attention/out/w`` and ``ff/out_proj/w`` -- split the input dim;
  * ``ff/in_proj/{w,b}`` -- split the output dim.  Rank r takes the gate
    and the value columns of the same hidden units, ``[r i/m, (r+1) i/m)``
    and ``i + [r i/m, (r+1) i/m)``, so ``gelu(x1) * x2`` needs no exchange
    (JAX splits the flat columns and GSPMD reshards); both compute the same
    function and checkpoints keep JAX's flat layout;
  * everything else (norms, ``kv_down``, the CNN, the decoder) is replicated,
    and so is a leaf that does not divide.
A model is sharded only where every rule leaf divides (``H`` and the FFN
width by ``model_size``): a half-sharded block would compute another
function.

Dropout under TP: the attention kernels' ``(2,)`` seed is folded with the
model index (:meth:`TensorParallel.fold_seed`), as JAX folds the key with
``axis_index("model")``; the plain attention route draws the mask of all H
heads and takes its own, so it gives the single-rank mask; draws on
replicated tensors (the FFN's output, stochastic depth) take the same
generator state on every model rank.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from .mesh import MODEL_AXIS, Mesh

# (enclosing module, leaf) -> which trailing dim to split: "col" the last
# (projection outputs, biases), "row" the second to last (projection
# inputs).  Only inside an "attention" / "ff" module (the decoder's "out"
# stays replicated).
_COL = {("q_up", "w"), ("k_up", "w"), ("v_up", "w"), ("in_proj", "w"), ("in_proj", "b")}
_ROW = {("out", "w"), ("out_proj", "w")}
_ATTENTION_TAILS = {("q_up", "w"), ("k_up", "w"), ("v_up", "w"), ("out", "w")}
_HEAD_PROJECTIONS = ("q_up", "k_up", "v_up")


def _names(path: str) -> tuple[str, ...]:
    """A JAX leaf path (``a/b/c``) or a port parameter name (``a.b.c``)."""
    return tuple(path.replace(".", "/").split("/"))


def tp_dim(names: tuple[str, ...]) -> Optional[str]:
    """"col", "row" or None for a leaf's names (JAX's ``_tp_dim``)."""
    if len(names) < 2:
        return None
    tail = names[-2:]
    module = "attention" if tail in _ATTENTION_TAILS else "ff"
    if module not in names:
        return None
    if tail in _COL:
        return "col"
    if tail in _ROW:
        return "row"
    return None


def split_axis(path: str, shape: tuple[int, ...], model_size: int,
               num_heads: int) -> Optional[int]:
    """The dim a leaf of ``shape`` splits over ``"model"``, counted from the
    end (-1 or -2), or None when it is replicated (JAX's ``_leaf_spec``).
    ``ff/in_proj`` splits in gate/value pairs, so its columns must divide
    by ``2 * model_size``."""
    names = _names(path)
    kind = tp_dim(names)
    ndim = len(shape)
    if kind == "col" and ndim >= (2 if names[-1] == "w" else 1):
        if names[-2] == "in_proj":
            return -1 if shape[-1] % (2 * model_size) == 0 else None
        head_proj = names[-2] in _HEAD_PROJECTIONS
        if shape[-1] % model_size == 0 and not (head_proj and num_heads % model_size):
            return -1
    elif kind == "row" and ndim >= 2 and shape[-2] % model_size == 0:
        return -2
    return None


def tp_spec_tree(shapes: Mapping[str, tuple[int, ...]], model_size: int,
                 num_heads: int) -> dict[str, int]:
    """{path: split dim} of the leaves that shard: the rule table of a tree
    of shapes (JAX's ``tp_spec_tree`` gives the same dims as shardings)."""
    axes = {}
    for path, shape in shapes.items():
        axis = split_axis(path, tuple(shape), model_size, num_heads)
        if axis is not None:
            axes[path] = axis
    return axes


def _paired(path: str) -> bool:
    return _names(path)[-2] == "in_proj"


def take_shard(x, path: str, axis: int, model_size: int, index: int):
    """Rank ``index``'s slice of the full leaf ``x`` (numpy or torch)."""
    n = x.shape[axis]
    if _paired(path):
        half = n // 2
        per = half // model_size
        gate = _slice(x, axis, index * per, (index + 1) * per)
        value = _slice(x, axis, half + index * per, half + (index + 1) * per)
        return _cat([gate, value], axis)
    per = n // model_size
    return _slice(x, axis, index * per, (index + 1) * per)


def join_shards(parts, path: str, axis: int):
    """The inverse of :func:`take_shard` over every rank's slice, in order."""
    if _paired(path):
        half = parts[0].shape[axis] // 2
        gates = [_slice(p, axis, 0, half) for p in parts]
        values = [_slice(p, axis, half, 2 * half) for p in parts]
        return _cat(gates + values, axis)
    return _cat(list(parts), axis)


def _slice(x, axis: int, lo: int, hi: int):
    index = [slice(None)] * x.ndim
    index[axis] = slice(lo, hi)
    return x[tuple(index)]


def _cat(parts, axis: int):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def shard_flat(flat: Mapping[str, np.ndarray], axes: Mapping[str, int], model_size: int,
               index: int) -> dict[str, np.ndarray]:
    """A flat JAX parameter dict in full layout -> rank ``index``'s slices
    (leading ``(E,)`` or ``(L,)`` axes carry through: the split dims count
    from the end)."""
    return {path: (np.ascontiguousarray(take_shard(np.asarray(v), path, axes[path],
                                                   model_size, index))
                   if path in axes else v) for path, v in flat.items()}


def unshard_flat(flat: Mapping[str, np.ndarray], axes: Mapping[str, int],
                 mesh: Mesh) -> dict[str, np.ndarray]:
    """This rank's slices -> the full JAX layout, gathered over ``"model"``
    (a collective: every model rank calls it)."""
    if mesh.extent(MODEL_AXIS) == 1:
        return dict(flat)
    out = {}
    for path, v in flat.items():
        if path not in axes:
            out[path] = v
            continue
        parts = mesh.all_gather(torch.from_numpy(np.ascontiguousarray(v)), MODEL_AXIS)
        out[path] = join_shards(list(parts.numpy()), path, axes[path])
    return out


class TensorParallel:
    """The model axis as a sharded model sees it: the mesh, this rank's
    index, the sharded parameters' names and the full layout's split dims.
    Held by the ``Model`` and by each attention and feed-forward module."""

    def __init__(self, mesh: Mesh, sharded: frozenset[str], axes: dict[str, int]):
        self.mesh = mesh
        self.size = mesh.extent(MODEL_AXIS)
        self.index = mesh.index(MODEL_AXIS)
        self.sharded = sharded
        self.axes = axes

    def __deepcopy__(self, memo):
        return self

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model ranks, in f32, cast back."""
        y = x.float().contiguous() if x.dtype != torch.float32 else x.contiguous().clone()
        self.mesh.all_reduce_(y, MODEL_AXIS)
        return y.to(x.dtype)

    def fold_seed(self, seed: torch.Tensor) -> torch.Tensor:
        """A kernel's (2,) int32 dropout seed decorrelated by the model
        index; index 0 keeps it."""
        if self.index == 0:
            return seed
        salt = torch.tensor([(self.index * 0x3C6EF372) & 0x7FFFFFFF,
                             (self.index * 0x1E3779B9) & 0x7FFFFFFF],
                            dtype=torch.int32, device=seed.device)
        return torch.bitwise_xor(seed, salt)

    def head_slice(self, num_heads: int) -> slice:
        per = num_heads // self.size
        return slice(self.index * per, (self.index + 1) * per)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Identity forward, the gradient summed over the model ranks."""
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """The partial products summed over the model ranks; identity backward."""
    return x if tp is None else _ReduceFromModel.apply(x, tp)


@torch.no_grad()
def shard_params_tp(model: nn.Module, mesh: Mesh, num_heads: int) -> nn.Module:
    """JAX's ``shard_params_tp`` on a port model, in place: replace
    ``model``'s sharded parameters (a ``Model``, or each member of an
    ``Ensemble``) by this rank's slices, and hand the
    :class:`TensorParallel` to the model and its attention and feed-forward
    modules.  Set up the optimizer afterwards."""
    from ..convert import state_dict_to_jax
    from ..models.model import Ensemble

    if isinstance(model, Ensemble):
        for member in model:
            shard_params_tp(member, mesh, num_heads)
        return model
    m = mesh.extent(MODEL_AXIS)
    if getattr(model, "tp", None) is not None:
        raise ValueError("the model is sharded already")
    inter = model.transformer.layers[0].get_submodule("local").ff.out_proj.w.shape[0]
    if num_heads % m or inter % m:
        raise ValueError(f"model_parallel_size {m} must divide the {num_heads} heads and the "
                         f"FFN width {inter}")
    full = state_dict_to_jax(model.state_dict())
    axes = tp_spec_tree({path: v.shape for path, v in full.items()}, m, num_heads)
    sharded = set()
    for name, param in list(model.named_parameters()):
        axis = split_axis(name, tuple(param.shape), m, num_heads)
        if axis is None:
            continue
        owner, leaf = name.rsplit(".", 1)
        local = take_shard(param.data, name, axis, m, mesh.index(MODEL_AXIS)).contiguous()
        model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
            local, requires_grad=param.requires_grad)
        sharded.add(name)
    tp = TensorParallel(mesh, frozenset(sharded), axes)
    from ..models.attention import SelfAttention
    from ..models.transformer import FeedForward

    model.tp = tp
    for module in model.modules():
        if isinstance(module, (SelfAttention, FeedForward)):
            module.tp = tp
    return model


def _tp_of(model: nn.Module) -> Optional[TensorParallel]:
    from ..models.model import Ensemble

    return getattr(model[0] if isinstance(model, Ensemble) else model, "tp", None)


def gather_flat(model: nn.Module) -> dict[str, np.ndarray]:
    """A (possibly sharded) ``Model``'s flat JAX parameters in full layout,
    or an ``Ensemble``'s with the leading ``(E,)`` axis (a collective under
    TP)."""
    from ..convert import params_to_jax

    flat = params_to_jax(model)
    tp = _tp_of(model)
    return flat if tp is None else unshard_flat(flat, tp.axes, tp.mesh)


def local_flat(model: nn.Module, flat: Mapping[str, np.ndarray]) -> Mapping[str, np.ndarray]:
    """A full-layout flat dict (``(E,)``-leading for an ``Ensemble``) -> the
    slices ``model`` holds (the dict itself when it is not sharded)."""
    tp = _tp_of(model)
    return flat if tp is None else shard_flat(flat, tp.axes, tp.size, tp.index)
