"""Genetic evolution of a population (capability parity with the reference's
train.py:472-570).

Counterpart of ``audio_to_midi_tpu/train/ensemble.py``, on the host in
numpy as there.  After each evaluation round the better half of the
population (by mean test-set loss, lower is better) is kept and every member
of the worse half is regenerated: crossover copies runs of two distinct
random winners' flattened weights, the run lengths Geometric(1e-6), then
pointwise mutation resamples ~N(0, 1) at rate 5e-4.  Populations of 2 or
fewer come back unchanged; one of 3 has a single winner, which cannot give a
child two distinct parents, and raises (JAX's raises in ``rng.choice``).

The population is the flat JAX parameter layout with a leading ``(E,)``
axis (``convert.stack_members``), walked in ``jax.tree.leaves`` order
(``convert.jax_leaf_order``): one run-stream spans every leaf of a child,
so the same scores and the same ``np.random.Generator`` state give JAX's
children bit for bit.  :func:`evolve_ensemble_` writes the children into an
``Ensemble``'s parameters in place, so that an optimizer bound to them keeps
updating them.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..convert import jax_leaf_order, load_params_, params_to_jax
from ..models.model import Ensemble

RECOMBINATION_RATE = 1e-6
MUTATION_RATE = 5e-4


class _RunState:
    """The geometric run-stream shared across all leaves of one child.

    The reference keeps the run length and the current parent as nonlocals
    that persist across every leaf, so one stream of ~Geometric(1e-6) runs
    covers the whole flattened model and a run can span leaf boundaries.
    The parent starts at b and flips on the first draw, so the first run
    copies parent a.
    """

    __slots__ = ("remaining", "use_b")

    def __init__(self) -> None:
        self.remaining = 0
        self.use_b = True


def _recombine_leaf(leaf: np.ndarray, parent_a: int, parent_b: int, result: int,
                    rng: np.random.Generator, state: _RunState) -> np.ndarray:
    if not np.issubdtype(leaf.dtype, np.floating):
        return leaf
    a = leaf[parent_a].reshape(-1)
    b = leaf[parent_b].reshape(-1)
    n = a.shape[0]
    out = np.empty_like(a)
    pos = 0
    while pos < n:
        if state.remaining <= 0:
            state.remaining = int(rng.geometric(RECOMBINATION_RATE))
            state.use_b = not state.use_b
        src = b if state.use_b else a
        end = min(pos + state.remaining, n)
        out[pos:end] = src[pos:end]
        state.remaining -= end - pos
        pos = end
    mutate = rng.random(n) < MUTATION_RATE
    out[mutate] = rng.standard_normal(np.count_nonzero(mutate)).astype(out.dtype)
    updated = np.array(leaf)
    updated[result] = out.reshape(leaf.shape[1:])
    return updated


def evolve_model_ensemble(params: Mapping[str, np.ndarray], ensemble_scores,
                          rng: np.random.Generator):
    """params: flat JAX layout, every leaf ``(E, ...)``; scores: (E,), lower
    is better.  Returns the evolved flat dict (``params`` itself for E <= 2)."""
    scores = np.asarray(ensemble_scores)
    if scores.shape[0] <= 2:
        return params
    order = list(np.argsort(scores))
    winners = order[: len(order) // 2]
    losers = order[len(order) // 2:]
    if len(winners) < 2:
        # JAX's rng.choice(1, size=2, replace=False) raises here as well.
        raise ValueError(f"a population of {len(order)} has {len(winners)} winner: a child "
                         "needs two distinct parents, so evolve 2 members or at least 4")
    host = {path: np.asarray(params[path]) for path in jax_leaf_order(params)}
    for result_idx in losers:
        pa, pb = rng.choice(len(winners), size=2, replace=False)
        parent_a, parent_b = winners[pa], winners[pb]
        state = _RunState()
        host = {path: _recombine_leaf(leaf, parent_a, parent_b, result_idx, rng, state)
                for path, leaf in host.items()}
    return host


@torch.no_grad()
def evolve_ensemble_(ensemble, ensemble_scores, rng: np.random.Generator,
                     mesh=None) -> list[int]:
    """Evolve ``ensemble`` in place: each regenerated member's child is
    copied into its existing parameters.  Returns the regenerated members'
    indices (none for E <= 2).

    On a ``mesh`` of several ranks (a collective) ``ensemble`` is what this
    rank holds -- its one member on an ensemble axis -- possibly sharded:
    the population is gathered in full layout on every rank, every rank
    runs the same evolution (the same scores and ``rng`` state), and each
    copies its own regenerated members back into its parameters."""
    from ..parallel.mesh import ENSEMBLE_AXIS, gather_params
    from ..parallel.tp import local_flat

    scores = np.asarray(ensemble_scores)
    on_axis = mesh is not None and mesh.extent(ENSEMBLE_AXIS) > 1
    if not on_axis and scores.shape[0] != len(ensemble):
        raise ValueError(f"{scores.shape[0]} scores for a population of {len(ensemble)}")
    params = params_to_jax(ensemble) if mesh is None else gather_params(ensemble, mesh)
    evolved = evolve_model_ensemble(params, scores, rng)
    if evolved is params:
        return []
    losers = [int(i) for i in np.argsort(scores)[len(scores) // 2:]]
    held = {mesh.index(ENSEMBLE_AXIS): ensemble} if on_axis else dict(enumerate(ensemble))
    for i in losers:
        if i in held:
            load_params_(held[i], local_flat(held[i],
                                             {path: leaf[i] for path, leaf in evolved.items()}))
    return losers

