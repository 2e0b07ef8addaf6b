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
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

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
