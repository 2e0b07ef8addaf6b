"""Weight converter between the JAX parameter tree and the port's state_dict.

The JAX side is the ``models/model.init`` tree flattened to
``{"cnn/stages/5/blocks/pw1/w": ndarray, ...}`` (:func:`flatten_tree` does
that for any nested dict/list of arrays; ``tools/export_params_npz.py``
writes it from a checkpoint).  The mapping, leaf by leaf:

* **Stacked leaves** are unstacked.  ``cnn/stages/{i}/blocks/...`` carries a
  leading ``(depth,)`` axis and becomes ``cnn.stages.{i}.blocks.{j}....``
  for each block j; ``transformer/{local,global}/...`` carries a leading
  ``(layers,)`` axis and becomes ``transformer.layers.{j}.{local,global}...``.
  The reverse direction stacks them again.
* **Every array keeps its layout.**  The port's modules store the JAX
  layouts: linear weights ``(in, out)``, convolution weights WIO
  ``(K, C_in/groups, C_out)`` -- the depthwise ``(K, 1, C)`` is permuted to
  torch's ``(C, 1, K)`` only at the ``F.conv1d`` call -- and q_up/k_up
  columns already in RoPE-halves order.  Values are copied bit for bit.
* Every other path maps ``/`` to ``.``.

A population (``models/model.Ensemble``) is laid out as the JAX package
keeps it: every leaf gains a leading ``(E,)`` axis (:func:`stack_members`,
:func:`unstack_members`; :func:`params_to_jax` and :func:`load_params_` for
a ``Model`` or an ``Ensemble``).  :func:`jax_leaf_order` gives the order in which
``jax.tree.leaves`` walks such a tree: dict keys sorted, list indices in
numeric order, one leaf per stacked array.

For one stage on its own, :func:`stage_blocks_from_jax` turns the stacked
``blocks`` subtree into the port's ``Block`` modules, and
:func:`stage_grads_to_jax` lays the gradients of the stage kernels' stacked
operands (``ops/convnext_kernels.WEIGHT_NAMES``) out like that subtree.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .models.model import Ensemble

_CNN_BLOCKS = re.compile(r"^cnn/stages/(\d+)/blocks/(.+)$")
_TRANSFORMER = re.compile(r"^transformer/(local|global)/(.+)$")
_CNN_BLOCK_KEY = re.compile(r"^cnn\.stages\.(\d+)\.blocks\.(\d+)\.(.+)$")
_LAYER_KEY = re.compile(r"^transformer\.layers\.(\d+)\.(local|global)\.(.+)$")


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists/tuples of arrays -> ``{"a/0/b": ndarray}``."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat: dict[str, np.ndarray] = {}
    for key, sub in items:
        flat.update(flatten_tree(sub, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def _leaf_order_key(path: str) -> tuple:
    # A list index sorts by its number; a dict key by its text.
    return tuple((0, int(part), "") if part.isdigit() else (1, 0, part)
                 for part in path.split("/"))


def jax_leaf_order(flat: Mapping[str, Any]) -> list[str]:
    """The paths of a flat JAX parameter dict in ``jax.tree.leaves`` order
    (``stages/10`` after ``stages/9``, which a text sort would not give)."""
    return sorted(flat, key=_leaf_order_key)


def stack_members(flats: list[Mapping[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """One flat dict per member -> one flat dict whose leaves lead with
    ``(E,)``."""
    return {path: np.stack([np.asarray(flat[path]) for flat in flats]) for path in flats[0]}


def unstack_members(flat: Mapping[str, np.ndarray]) -> list[dict[str, np.ndarray]]:
    """The inverse of :func:`stack_members`."""
    sizes = {np.shape(v)[0] for v in flat.values()}
    if len(sizes) != 1:
        raise ValueError(f"the leaves disagree on the population axis: {sorted(sizes)}")
    return [{path: np.asarray(v[i]) for path, v in flat.items()} for i in range(sizes.pop())]


def params_to_jax(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """A ``Model``'s flat JAX parameter dict, or an ``Ensemble``'s with the
    leading ``(E,)`` axis."""
    if isinstance(model, Ensemble):
        return stack_members([state_dict_to_jax(m.state_dict()) for m in model])
    return state_dict_to_jax(model.state_dict())


@torch.no_grad()
def load_params_(model: torch.nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Copy a flat JAX parameter dict into ``model``'s parameters in place,
    so that an optimizer bound to them stays bound.  For an ``Ensemble``
    every leaf must lead with its population size."""
    if not isinstance(model, Ensemble):
        model.load_state_dict(jax_to_state_dict(flat), strict=True)
        return
    reference = state_dict_to_jax(model[0].state_dict())
    for path, value in flat.items():
        want = (len(model), *reference[path].shape) if path in reference else None
        if want is not None and value.shape != want:
            raise ValueError(f"{path}: the checkpoint's shape {value.shape} is not the "
                             f"population's {want} (ensemble_size {len(model)})")
    for member, member_flat in zip(model, unstack_members(flat), strict=True):
        member.load_state_dict(jax_to_state_dict(member_flat), strict=True)


def jax_to_state_dict(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat JAX parameter dict -> the port's ``Model`` state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        arr = np.asarray(value)
        if m := _CNN_BLOCKS.match(path):
            stage, leaf = m.groups()
            for j in range(arr.shape[0]):
                key = f"cnn.stages.{stage}.blocks.{j}.{leaf.replace('/', '.')}"
                sd[key] = torch.from_numpy(np.array(arr[j]))
        elif m := _TRANSFORMER.match(path):
            kind, leaf = m.groups()
            for j in range(arr.shape[0]):
                key = f"transformer.layers.{j}.{kind}.{leaf.replace('/', '.')}"
                sd[key] = torch.from_numpy(np.array(arr[j]))
        else:
            sd[path.replace("/", ".")] = torch.from_numpy(np.array(arr))
    return sd


def state_dict_to_jax(sd: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's state_dict -> flat JAX parameter dict (stacked leaves)."""
    stacks: dict[str, dict[int, np.ndarray]] = {}
    flat: dict[str, np.ndarray] = {}
    for key, tensor in sd.items():
        arr = tensor.detach().cpu().numpy()
        if m := _CNN_BLOCK_KEY.match(key):
            stage, j, leaf = m.groups()
            path = f"cnn/stages/{stage}/blocks/{leaf.replace('.', '/')}"
            stacks.setdefault(path, {})[int(j)] = arr
        elif m := _LAYER_KEY.match(key):
            j, kind, leaf = m.groups()
            path = f"transformer/{kind}/{leaf.replace('.', '/')}"
            stacks.setdefault(path, {})[int(j)] = arr
        else:
            flat[key.replace(".", "/")] = arr
    for path, parts in stacks.items():
        if sorted(parts) != list(range(len(parts))):
            raise ValueError(f"{path}: stacked indices {sorted(parts)} are not 0..n-1")
        flat[path] = np.stack([parts[j] for j in range(len(parts))])
    return flat


def save_npz(path: str | Path, flat: Mapping[str, np.ndarray]) -> None:
    """Write a flat JAX parameter dict as ``.npz`` (keys are the paths)."""
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_npz(path: str | Path) -> dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def stage_blocks_from_jax(blocks: Any) -> torch.nn.ModuleList:
    """The stacked ``blocks`` subtree of one CNN stage (leaves lead with
    ``(depth,)``) -> that stage's ``models/convnext.Block`` modules."""
    from .models.convnext import Block

    flat = flatten_tree(blocks)
    depth, k, _, channels = flat["depth_conv/w"].shape
    hidden = flat["pw1/w"].shape[-1]
    modules = torch.nn.ModuleList(Block(channels, hidden, None, k) for _ in range(depth))
    for j, module in enumerate(modules):
        module.load_state_dict({path.replace("/", "."): torch.from_numpy(np.array(leaf[j]))
                                for path, leaf in flat.items()}, strict=True)
    return modules


def stage_grads_to_jax(grads) -> dict[str, np.ndarray]:
    """The eight gradients of the stage kernels' stacked operands (dw, dwb,
    ln, pw1, pw1b, pw2, pw2b, gamma) -> ``{"depth_conv/w": ...}`` with the
    shapes of the stacked ``blocks`` subtree."""
    dw, dwb, ln, pw1, pw1b, pw2, pw2b, gamma = (g.detach().float().cpu().numpy() for g in grads)
    return {
        "depth_conv/w": dw[:, :, None, :], "depth_conv/b": dwb[:, 0],
        "norm/scale": ln[:, 0], "norm/bias": ln[:, 1],
        "pw1/w": pw1, "pw1/b": pw1b[:, 0], "pw2/w": pw2, "pw2/b": pw2b[:, 0],
        "gamma": gamma[:, 0],
    }
