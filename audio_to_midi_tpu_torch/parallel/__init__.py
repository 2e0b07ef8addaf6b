"""Data, tensor and ensemble parallelism over ``torch.distributed``: the
counterpart of ``audio_to_midi_tpu/parallel``, one process per rank.  JAX's
exports by JAX's names where the port has a counterpart; ``place_model``
stands for JAX's ``shard_params`` and ``make_param_placer`` (one rank's
member or shards of a model), ``local_minibatches`` for ``batch_spec`` (this
rank's "data" slice of a batch)."""

from . import mesh, tp
from .mesh import (
    DATA_AXIS,
    ENSEMBLE_AXIS,
    MODEL_AXIS,
    Mesh,
    gather_params,
    initialize_multihost,
    local_minibatches,
    make_mesh,
    place_model,
    tp_active,
)
from .tp import shard_flat, shard_params_tp, tp_spec_tree, unshard_flat

__all__ = [
    "mesh",
    "tp",
    "DATA_AXIS",
    "ENSEMBLE_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "gather_params",
    "initialize_multihost",
    "local_minibatches",
    "make_mesh",
    "place_model",
    "shard_flat",
    "shard_params_tp",
    "tp_active",
    "tp_spec_tree",
    "unshard_flat",
]
