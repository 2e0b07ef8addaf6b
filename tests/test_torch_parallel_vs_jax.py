"""The port's parallel/ package against the JAX package's: the mesh rules
(shapes, raise and warning texts), the tensor-parallel rules over every leaf
of the default tree, the TP 2 forward, and the train step on the meshes
(1, 2, 1) and (1, 1, 2) against JAX's step on the same mesh shapes of
virtual CPU devices (the population's layouts are in
tests/test_torch_parallel_ensemble_vs_jax.py).

The port's ranks run in spawned processes (tests/test_torch_parallel.py's
harness and jobs, which import no JAX); the comparisons run here.

Tolerances, f32 on both sides: probabilities and losses relative 1e-5 (the
same sums in another order: the TP all-reduce, the data mean); the updates
after one step within JAX's own ``_assert_updates_match`` limits (tests/
test_parallel.py: Adam at step 0 turns a reassociation of ~1e-7 in a small
gradient into up to 1e-3 of an update of 1e-2), the step taken with
``warmup_steps=0`` and lr 1e-2 so that the updates are not vacuous.  The
JAX side runs the einsum attention (``"xla"``), which GSPMD partitions; the
port the kernel wrappers (``"pallas"``: their plain versions on the CPU).
"""

from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.parallel import mesh as jax_mesh
from audio_to_midi_tpu.parallel import tp as jax_tp
from audio_to_midi_tpu.train import make_train_step as jax_make_train_step
from audio_to_midi_tpu.train import reshape_to_minibatches as jax_reshape
from audio_to_midi_tpu.train import setup_optimizers as jax_setup_optimizers
from audio_to_midi_tpu.train.loss import batch_loss as jax_batch_loss
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.parallel import mesh as pmesh
from audio_to_midi_tpu_torch.parallel import tp as ptp
from tests.test_parallel import _assert_updates_match
from tests.test_torch_parallel import batch, jobs, run_ranks, seeded_flat, tiny_cfg

torch.set_num_threads(2)


def jax_cfg(cfg: pt_config.Config, **model) -> jax_config.Config:
    out = jax_config.config_from_json(pt_config.config_to_json(cfg))
    return dataclasses.replace(out, model=dataclasses.replace(out.model, **model))


def population(cfg: pt_config.Config, e: int) -> dict:
    """The port's seeded population of ``e`` as a flat numpy dict, every
    leaf (E,)-leading (JAX's layout of a population)."""
    flat = seeded_flat(cfg, 0, e)
    return {k: v[None] for k, v in flat.items()} if e == 1 else flat


def jax_tree(cfg: pt_config.Config, flat: dict, ensemble: bool = True):
    """The flat dict as the JAX package's parameter tree (of a population
    when ``ensemble``)."""
    model_cfg = jax_cfg(cfg).model
    shapes = jax.eval_shape(lambda k: jax_model.init_ensemble(k, model_cfg, 1)[0] if ensemble
                            else jax_model.init(k, model_cfg)[0], jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(flat[jax.tree_util.keystr(p, simple=True, separator="/")]),
        shapes)


def jax_step(cfg: pt_config.Config, layout, flat, audio, labels):
    """JAX's train step on the mesh ``layout`` of virtual devices (tests/
    test_parallel.py's _one_train_step) from the (E,)-leading ``flat``:
    loss (E,) and the params after."""
    e, d, m = layout
    jcfg = jax_cfg(cfg, attention_impl="xla")
    mesh = jax_mesh.make_mesh(e, devices=jax.devices()[:e * d * m], model_size=m)
    rope = jax_model.make_rope(jcfg.model)
    params = jax_tree(cfg, flat)
    place = jax_mesh.make_param_placer(mesh, jcfg.model.num_transformer_heads)
    params = place(params, ensemble=e > 1)
    tx, _ = jax_setup_optimizers(params, jcfg.model, jcfg.train, ensemble=True)
    opt_state = place(jax.vmap(tx.init)(params), ensemble=e > 1)
    step = jax_make_train_step(jcfg, tx, rope, mesh=mesh, ensemble=True)
    spec = jax_mesh.batch_spec(mesh, 1)
    out = step(params, opt_state, jax.device_put(jax_reshape(jnp.asarray(audio), 8), spec),
               jax.device_put(jax_reshape(jnp.asarray(labels), 8), spec),
               jax.random.PRNGKey(3), jnp.asarray(1.0, jnp.float32))
    return np.asarray(out.loss), convert.flatten_tree(jax.device_get(out.params))


def jax_grads(cfg: pt_config.Config, layout, flat, audio, labels) -> dict:
    """The gradients JAX's step feeds its optimizer (the mean over the
    minibatches of ``batch_loss``'s, dropout off), on the mesh ``layout``
    with the step's placement and batch sharding, from the (E,)-leading
    ``flat``: a flat (E,)-leading dict."""
    e, d, m = layout
    jcfg = jax_cfg(cfg, attention_impl="xla")
    mesh = jax_mesh.make_mesh(e, devices=jax.devices()[:e * d * m], model_size=m)
    rope = jax_model.make_rope(jcfg.model)
    place = jax_mesh.make_param_placer(mesh, jcfg.model.num_transformer_heads)
    params = place(jax_tree(cfg, flat), ensemble=e > 1)

    def member(p, audio_mb, labels_mb):
        def one(a, lab):
            return jax.grad(jax_batch_loss)(p, jcfg.model, a, lab, rope, jnp.float32(1.0),
                                            jax.random.PRNGKey(3), jnp.float32)

        grads = jax.vmap(one)(audio_mb, labels_mb)
        return jax.tree.map(lambda g: g.sum(0) / audio_mb.shape[0], grads)

    spec = jax_mesh.batch_spec(mesh, 1)
    grads = jax.jit(jax.vmap(member, in_axes=(0, None, None)))(
        params, jax.device_put(jax_reshape(jnp.asarray(audio), 8), spec),
        jax.device_put(jax_reshape(jnp.asarray(labels), 8), spec))
    return convert.flatten_tree(jax.device_get(grads))


# --- rules, in one process -----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_layout_matches_jax(n):
    devices = jax.devices()[:n]
    for e in (1, 2, 3, 4):
        for m in (1, 2, 4):
            outcomes = []
            for make in (lambda: jax_mesh.make_mesh(e, devices=devices, model_size=m),
                         lambda: pmesh.make_mesh(e, world_size=n, model_size=m)):
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    try:
                        outcomes.append((dict(make().shape), None,
                                         [str(w.message) for w in caught]))
                    except ValueError as err:
                        outcomes.append((None, str(err), [str(w.message) for w in caught]))
            assert outcomes[0] == outcomes[1], (n, e, m)


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("ensemble", [False, True])
def test_tp_rules_match_jax_on_the_default_tree(model_size, ensemble):
    cfg = jax_config.ModelConfig()
    shapes = jax.eval_shape(
        lambda k: jax_model.init_ensemble(k, cfg, 2)[0] if ensemble else
        jax_model.init(k, cfg)[0], jax.random.PRNGKey(0))
    mesh = jax_mesh.make_mesh(1, devices=jax.devices()[:model_size], model_size=model_size)
    specs = jax_tp.tp_spec_tree(shapes, mesh, num_heads=cfg.num_transformer_heads,
                                ensemble=ensemble)
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: hasattr(x, "spec"))
    sharded = 0
    for (path, leaf), spec in zip(leaves, spec_leaves, strict=True):
        name = jax.tree_util.keystr(path, simple=True, separator="/")
        dims = tuple(spec.spec) + (None,) * (leaf.ndim - len(spec.spec))
        want = [i - leaf.ndim for i, d in enumerate(dims) if d == "model"]
        got = ptp.split_axis(name, leaf.shape, model_size, cfg.num_transformer_heads)
        assert ([got] if got is not None else []) == want, name
        if got is not None:
            sharded += 1
            x = np.random.default_rng(0).standard_normal(leaf.shape).astype(np.float32)
            parts = [ptp.take_shard(x, name, got, model_size, r) for r in range(model_size)]
            np.testing.assert_array_equal(ptp.join_shards(parts, name, got), x)
    assert sharded == 2 * 7  # local and global: q/k/v_up, out, in_proj w and b, out_proj
    axes = ptp.tp_spec_tree({jax.tree_util.keystr(p, simple=True, separator="/"): leaf.shape
                           for p, leaf in leaves}, model_size, cfg.num_transformer_heads)
    assert len(axes) == sharded and "transformer/local/attention/kv_down/w" not in axes


# --- groups of ranks ---------------------------------------------------------------

LAYOUTS = {"dp2": (1, 2, 1), "tp2": (1, 1, 2)}


@pytest.fixture(scope="module")
def data():
    cfg = tiny_cfg()
    audio, labels = batch(1, cfg)
    return cfg, audio, labels


@pytest.fixture(scope="module")
def pair(tmp_path_factory, data):
    """One group of 2 ranks: the TP 2 forward, and a step on DP 2 and TP 2."""
    cfg, audio, labels = data
    flat = {k: v[0] for k, v in population(cfg, 1).items()}
    forwards = [("pallas", cfg, False), ("xla", tiny_cfg(impl="xla"), False),
                ("xla dropout", tiny_cfg(impl="xla", dropout=0.1), True)]
    steps = [(name, (cfg, flat, layout, audio, labels), {}) for name, layout in LAYOUTS.items()]
    ranks = run_ranks(tmp_path_factory.mktemp("pair_vs_jax"), 2, jobs, {
        "forward": ("forward_job", {"forwards": forwards, "flat": flat, "audio": audio[:4]}),
        "steps": ("steps_job", {"steps": steps})})
    return {"forward": [r["forward"] for r in ranks], "steps": [r["steps"] for r in ranks],
            "flat": flat}


def test_tp_forward_matches_jax_and_one_rank(pair, data):
    """TP 2 against JAX's forward on a (1, 1, 2) mesh and against the
    port's single rank, "pallas" and "xla"; with "xla" and dropout (the
    plain route), the single rank's masks."""
    cfg, audio, _ = data
    jcfg = jax_cfg(cfg, attention_impl="xla")
    mesh = jax_mesh.make_mesh(1, devices=jax.devices()[:2], model_size=2)
    sharded = jax_tp.shard_params_tp(jax_tree(cfg, pair["flat"], ensemble=False), mesh,
                                     num_heads=jcfg.model.num_transformer_heads)
    rope = jax_model.make_rope(jcfg.model)
    ref = np.asarray(jax.jit(lambda p, a: jax_model.forward(p, jcfg.model, a, rope)[1])(
        sharded, jnp.asarray(audio[:4])))
    for rank in pair["forward"]:
        for name in ("pallas", "xla"):
            np.testing.assert_allclose(rank[name]["tp"], ref, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(rank[name]["tp"], rank[name]["single"], rtol=1e-5,
                                       atol=1e-6)
        got = rank["xla dropout"]
        np.testing.assert_allclose(got["tp"], got["single"], rtol=1e-5, atol=1e-6)
        assert not np.allclose(got["tp"], rank["xla"]["tp"])


def assert_grads_match(got: dict, want: dict) -> None:
    """Every leaf's gradient within 1e-5 of the leaf's largest |gradient|:
    the same f32 sums in another order (the "data" all-reduce, TP's partial
    products), measured at most 5.1e-7 on these layouts.  A missing division
    over "data", or a partial sum counted twice, is an error of the order of
    the gradient itself."""
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f"gradient of {k}")


def check_step(got_ranks, cfg, layout, flat, audio, labels):
    """Each rank's loss, gradients and gathered parameters after one step
    against JAX's step on the same mesh shape from the same (E,)-leading
    ``flat``; without a population, every rank's parameters bit for bit
    alike."""
    loss, params = jax_step(cfg, layout, flat, audio, labels)
    grads = jax_grads(cfg, layout, flat, audio, labels)
    e = layout[0]
    lead = (lambda d: d) if e > 1 else (lambda d: {k: v[None] for k, v in d.items()})
    for got in got_ranks:
        np.testing.assert_allclose(np.reshape(got["losses"][0], -1), loss, rtol=1e-5)
        mine = lead(got["params"])
        assert mine.keys() == params.keys() == grads.keys()
        assert_grads_match(lead(got["grads"]), grads)
        _assert_updates_match({k: params[k] - flat[k] for k in params},
                              {k: mine[k] - flat[k] for k in params})
    if e == 1:
        assert len({g["digest_replicated"] for g in got_ranks}) == 1
        assert all(np.array_equal(got_ranks[0]["params"][k], g["params"][k])
                   for g in got_ranks for k in params)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_step_on_two_ranks_matches_jax(pair, data, name):
    cfg, audio, labels = data
    check_step([r[name] for r in pair["steps"]], cfg, LAYOUTS[name], population(cfg, 1),
               audio, labels)
