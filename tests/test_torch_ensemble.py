"""The port's ensemble axis against the JAX package's: the leaf order, the
population's init and layout, the ensemble step (JAX vmaps the members, the
port runs them in turn), the genetic evolution (bit for bit), checkpoints of
a population, its evaluation, and the loop with evaluation, evolution and
the f16 rollback.

Tolerances: the step and the evaluation as the loop's comparison with JAX
(tests/test_torch_train_loop.py): losses relative 1e-5, parameters within
1e-5 of each leaf's largest magnitude, f32 on both sides.  Everything the
port computes from the same bits on the host (evolution, layouts,
checkpoints) must be equal bit for bit, and so must a member of an ensemble
step and the one-member step on its weights and generator.
"""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.train import ensemble as jax_ensemble
from audio_to_midi_tpu.train import evaluate as jax_evaluate
from audio_to_midi_tpu.train import optim as jax_optim
from audio_to_midi_tpu.train import step as jax_step
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch import infer as pt_infer
from audio_to_midi_tpu_torch.data import synthetic
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.train import checkpoint as ckpt
from audio_to_midi_tpu_torch.train import ensemble as pt_ensemble
from audio_to_midi_tpu_torch.train import evaluate as pt_evaluate
from audio_to_midi_tpu_torch.train import loop as pt_loop
from audio_to_midi_tpu_torch.train import optim as pt_optim
from audio_to_midi_tpu_torch.train import step as pt_step
from tests.test_torch_primitives import port_config
from tests.test_torch_train_loop import JAX_CFG as LOOP_JAX_CFG
from tests.test_torch_train_loop import FRAMES as LOOP_FRAMES
from tests.test_torch_train_loop import port_cfg as loop_port_cfg

torch.set_num_threads(2)

# The JAX package's tests/test_train.py SMALL_MODEL: two stages, one pair.
SMALL_MODEL = jax_config.ModelConfig(
    dims=(4, 8), depths=(1, 1), num_transformer_layers=1, num_transformer_heads=2,
    attention_size=8, compressed_attention_kv_size=8, compressed_attention_q_size=8,
    transformer_dropout_rate=0.0, attention_impl="pallas", cnn_impl="xla")


def small_config(**train) -> jax_config.Config:
    return jax_config.Config(
        model=SMALL_MODEL, precision=jax_config.PrecisionConfig(compute_dtype=jnp.float32),
        train=dataclasses.replace(jax_config.TrainConfig(), batch_size=4,
                                  minibatch_size_per_device=2, warmup_steps=0,
                                  base_learning_rate=1e-2, num_steps=100, **train))


@functools.lru_cache(maxsize=None)
def _jax_tree(seed: int, size: int, model_cfg=SMALL_MODEL):
    init = jax.jit(lambda key: jax_model.init_ensemble(key, model_cfg, size)[0])
    return jax.device_get(init(jax.random.PRNGKey(seed)))


def jax_tree(seed: int, size: int, model_cfg=SMALL_MODEL):
    """JAX's init_ensemble as a numpy tree, every leaf (E, ...) (a copy)."""
    return jax.tree.map(np.array, _jax_tree(seed, size, model_cfg))


def jax_population(seed: int, size: int, model_cfg=SMALL_MODEL) -> dict[str, np.ndarray]:
    """JAX's init_ensemble as a flat numpy dict."""
    return convert.flatten_tree(jax_tree(seed, size, model_cfg))


def port_population(flat: dict[str, np.ndarray], cfg: pt_config.Config) -> pt_model.Ensemble:
    members = []
    for member in convert.unstack_members(flat):
        model = pt_model.Model(cfg.model)
        model.load_state_dict(convert.jax_to_state_dict(member), strict=True)
        members.append(model)
    return pt_model.Ensemble(members)


def data(seed: int, lead: tuple[int, ...], num_samples: int = 200):
    """Seeded audio (*lead, 2, N) and sparse labels (*lead, F, 90)."""
    rng = np.random.default_rng(seed)
    frames = SMALL_MODEL.output_frames(num_samples)
    audio = rng.standard_normal((*lead, 2, num_samples)).astype(np.float32)
    labels = (rng.random((*lead, frames, 90)) > 0.9).astype(np.float32)
    return audio, labels


def assert_leaves_close(mine: dict, ref: dict, share: float = 1e-5):
    assert mine.keys() == ref.keys()
    for path, r in ref.items():
        r = np.asarray(r)
        finite = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(mine[path]), finite, err_msg=path)
        scale = np.abs(r[finite]).max() if finite.any() else 0.0
        assert np.abs(mine[path][finite] - r[finite]).max(initial=0.0) <= share * scale, path


# --- layout: the leaf order, stacking, init ------------------------------------------


def test_jax_leaf_order_is_the_jax_tree_order():
    params = jax_tree(0, 4)
    flat = convert.flatten_tree(params)
    ref = [jax.tree_util.keystr(p, simple=True, separator="/")
           for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert convert.jax_leaf_order(flat) == ref
    # A list of 12: index 10 after 9, where a text sort puts it after 1.
    tree = {"b": [{"w": np.zeros(1), "a": np.ones(1)} for _ in range(12)], "a": np.zeros(2)}
    ref = [jax.tree_util.keystr(p, simple=True, separator="/")
           for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert convert.jax_leaf_order(convert.flatten_tree(tree)) == ref
    assert ref.index("b/10/a") == ref.index("b/9/w") + 1


def test_stack_and_unstack_members_round_trip():
    flat = jax_population(0, 4)
    members = convert.unstack_members(flat)
    assert len(members) == 4
    again = convert.stack_members(members)
    assert again.keys() == flat.keys()
    assert all(np.array_equal(again[k], flat[k]) for k in flat)
    with pytest.raises(ValueError, match="population"):
        convert.unstack_members({"a": np.zeros((2, 1)), "b": np.zeros((3, 1))})


def test_init_ensemble_draws_each_member_from_a_generator_of_its_own():
    cfg = port_config(small_config())
    ensemble, state = pt_model.init_ensemble(torch.Generator().manual_seed(5), cfg.model, 3)
    assert isinstance(ensemble, pt_model.Ensemble) and len(ensemble) == 3 and state == {}
    # Member i is Model(cfg, generator i), the generators seeded from the caller's.
    seeds = torch.randint(0, 2 ** 62, (3,), generator=torch.Generator().manual_seed(5)).tolist()
    for member, seed in zip(ensemble, seeds):
        alone = pt_model.Model(cfg.model, torch.Generator().manual_seed(seed))
        assert all(torch.equal(a, b) for a, b in zip(member.parameters(), alone.parameters()))
    first = list(ensemble[0].parameters())
    assert not all(torch.equal(a, b) for a, b in zip(first, ensemble[1].parameters()))
    flat = convert.params_to_jax(ensemble)
    one = convert.state_dict_to_jax(ensemble[0].state_dict())
    assert all(flat[k].shape == (3, *one[k].shape) for k in one)


def test_setup_optimizers_binds_one_chain_per_member():
    cfg = port_config(small_config(ensemble_size=3))
    ensemble, _ = pt_model.init_ensemble(torch.Generator().manual_seed(0), cfg.model, 3)
    opt = pt_optim.setup_optimizers(ensemble, cfg.model, cfg.train)
    assert isinstance(opt, pt_optim.EnsembleOptimizer) and len(opt.members) == 3
    for member, chain in zip(ensemble, opt.members):
        assert all(a is b for a, b in zip(member.parameters(), chain.params))
    assert all(a is b for a, b in zip(ensemble.parameters(), opt.params))
    assert opt.counts == [0, 0, 0]
    snap = opt.snapshot()
    opt.members[1]._mu_flat.fill_(1.0)
    opt.restore(snap)
    assert not opt.members[1]._mu_flat.any()
    with pytest.raises(ValueError, match="Ensemble of 3"):
        pt_optim.setup_optimizers(ensemble[0], cfg.model, cfg.train)
    with pytest.raises(ValueError, match="one Model"):
        pt_optim.setup_optimizers(ensemble, cfg.model, dataclasses.replace(cfg.train,
                                                                           ensemble_size=1))


# --- the step -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ensemble_run():
    """JAX's vmapped step at E = 3 over two batches, the second with member
    1's decoder bias poisoned by a nan: (initial, [(loss, valid, params)]).
    JAX takes its einsum attention, which compiles in a fraction of the
    interpret-mode kernels' time; the port its kernels' plain versions,
    held against JAX's kernels elsewhere (tests/test_torch_train.py)."""
    model_cfg = dataclasses.replace(SMALL_MODEL, attention_impl="xla")
    jcfg = dataclasses.replace(small_config(ensemble_size=3), model=model_cfg)
    params = jax.tree.map(jnp.asarray, jax_tree(3, 3))
    init = convert.flatten_tree(jax.device_get(params))
    tx, _ = jax_optim.setup_optimizers(params, model_cfg, jcfg.train, ensemble=True)
    opt_state = jax.vmap(tx.init)(params)
    step = jax_step.make_train_step(jcfg, tx, jax_model.make_rope(model_cfg), mesh=None,
                                    ensemble=True)
    outs = []
    for i in range(2):
        if i == 1:
            params["decoder"]["out"]["b"] = params["decoder"]["out"]["b"].at[1, 7].set(jnp.nan)
        audio, labels = data(40 + i, (2, 2))
        out = step(params, opt_state, jnp.asarray(audio), jnp.asarray(labels),
                   jax.random.PRNGKey(i), jnp.float32(1.0))
        params, opt_state = out.params, out.opt_state
        outs.append((np.asarray(out.loss), np.asarray(out.grads_valid),
                     convert.flatten_tree(jax.device_get(params))))
    return init, outs


def test_ensemble_step_matches_jax_per_member(jax_ensemble_run):
    init, outs = jax_ensemble_run
    cfg = port_config(small_config(ensemble_size=3))
    ensemble = port_population(init, cfg)
    opt = pt_optim.setup_optimizers(ensemble, cfg.model, cfg.train)
    step = pt_step.make_train_step(cfg, opt, pt_model.make_rope(cfg.model))
    for i, (ref_loss, ref_valid, ref_params) in enumerate(outs):
        if i == 1:
            with torch.no_grad():
                ensemble[1].decoder.out.b[7] = float("nan")
            before = convert.params_to_jax(ensemble)
        audio, labels = data(40 + i, (2, 2))
        out = step(ensemble, torch.from_numpy(audio), torch.from_numpy(labels), 1.0)
        assert out.loss.shape == out.grads_valid.shape == out.scaled_loss.shape == (3,)
        np.testing.assert_array_equal(out.grads_valid.numpy(), ref_valid)
        finite = np.isfinite(ref_loss)
        np.testing.assert_array_equal(np.isfinite(out.loss.numpy()), finite)
        np.testing.assert_allclose(out.loss.numpy()[finite], ref_loss[finite], rtol=1e-5)
        assert_leaves_close(convert.params_to_jax(ensemble), ref_params)
    # The nan member kept its weights (and its nan) and its count; the others moved.
    assert list(ref_valid) == [True, False, True]
    after = convert.params_to_jax(ensemble)
    for k in after:
        np.testing.assert_array_equal(after[k][1], before[k][1], err_msg=k)
    assert all(any(not np.array_equal(after[k][m], before[k][m]) for k in after) for m in (0, 2))
    assert opt.counts == [2, 1, 2]


def test_a_member_of_an_ensemble_step_is_the_one_member_step():
    """Dropout 0.1: member i of an E = 3 step gives, bit for bit, the loss
    and parameters of a one-member step on its weights with its generator
    seed; E = 1 is that one-member step."""
    jcfg = small_config(ensemble_size=3)
    cfg = port_config(dataclasses.replace(
        jcfg, model=dataclasses.replace(SMALL_MODEL, transformer_dropout_rate=0.1)))
    one_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ensemble_size=1))
    ensemble, _ = pt_model.init_ensemble(torch.Generator().manual_seed(9), cfg.model, 3)
    singles = [pt_model.Model(cfg.model) for _ in range(3)]
    for single, member in zip(singles, ensemble):
        single.load_state_dict(member.state_dict())
    rope = pt_model.make_rope(cfg.model)
    step = pt_step.make_train_step(
        cfg, pt_optim.setup_optimizers(ensemble, cfg.model, cfg.train), rope)
    single_steps = [pt_step.make_train_step(
        one_cfg, pt_optim.setup_optimizers(s, cfg.model, one_cfg.train), rope) for s in singles]
    for i in range(2):
        audio, labels = (torch.from_numpy(x) for x in data(50 + i, (2, 2)))
        generator = torch.Generator().manual_seed(100 + i)
        seeds = torch.randint(0, 2 ** 62, (3,),
                              generator=torch.Generator().manual_seed(100 + i)).tolist()
        out = step(ensemble, audio, labels, 1.0, generator)
        for m, (single, single_step, seed) in enumerate(zip(singles, single_steps, seeds)):
            ref = single_step(single, audio, labels, 1.0, torch.Generator().manual_seed(seed))
            assert ref.loss.shape == ()
            assert torch.equal(out.loss[m], ref.loss) and bool(ref.grads_valid)
            assert all(torch.equal(a, b) for a, b in zip(ensemble[m].parameters(),
                                                         single.parameters()))
    # The members drew different masks: their losses differ.
    assert len(set(out.loss.tolist())) == 3


def test_make_train_step_refuses_a_mismatched_optimizer():
    cfg = port_config(small_config(ensemble_size=2))
    ensemble, _ = pt_model.init_ensemble(torch.Generator().manual_seed(0), cfg.model, 2)
    opt = pt_optim.setup_optimizers(ensemble, cfg.model, cfg.train)
    one = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ensemble_size=1))
    with pytest.raises(ValueError, match="one Model"):
        pt_step.make_train_step(one, opt, pt_model.make_rope(cfg.model))
    three = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ensemble_size=3))
    with pytest.raises(ValueError, match="Ensemble of 3"):
        pt_step.make_train_step(three, opt, pt_model.make_rope(cfg.model))


# --- evolution ------------------------------------------------------------------------


@pytest.mark.parametrize("recombination_rate", [jax_ensemble.RECOMBINATION_RATE, 2e-3])
@pytest.mark.parametrize("scores,seed", [([1.0, 3.0, 0.5, 2.0], 0), ([4.0, 1.0, 3.0, 2.0], 7)])
def test_evolution_matches_jax_bit_for_bit(monkeypatch, scores, seed, recombination_rate):
    """The same population, scores and numpy generator state give JAX's
    children bit for bit: through the flat function and written into an
    Ensemble in place.  At a rate of 2e-3 the runs switch parents many times
    within and across leaves."""
    monkeypatch.setattr(jax_ensemble, "RECOMBINATION_RATE", recombination_rate)
    monkeypatch.setattr(pt_ensemble, "RECOMBINATION_RATE", recombination_rate)
    params = jax_tree(0, 4)
    flat = convert.flatten_tree(params)
    ref = convert.flatten_tree(jax_ensemble.evolve_model_ensemble(
        params, np.array(scores), np.random.default_rng(seed)))
    ours = pt_ensemble.evolve_model_ensemble(flat, np.array(scores), np.random.default_rng(seed))
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)

    ensemble = port_population(flat, port_config(small_config()))
    bound = [p for p in ensemble.parameters()]
    regenerated = pt_ensemble.evolve_ensemble_(ensemble, scores, np.random.default_rng(seed))
    order = list(np.argsort(scores))
    assert regenerated == [int(i) for i in order[2:]]
    after = convert.params_to_jax(ensemble)
    for k in ref:
        np.testing.assert_array_equal(after[k], ref[k], err_msg=k)
        for winner in order[:2]:
            np.testing.assert_array_equal(after[k][winner], flat[k][winner], err_msg=k)
    assert all(a is b for a, b in zip(bound, ensemble.parameters()))  # in place
    changed = [any(not np.array_equal(after[k][m], flat[k][m]) for k in flat) for m in range(4)]
    assert [changed[int(i)] for i in order] == [False, False, True, True]


def test_evolution_crossleaf_run_stream():
    """JAX's tests/test_train.py case on the port: one geometric run-stream
    spans every leaf of a child, and the first run copies parent a."""

    class ScriptedRng:
        def __init__(self, runs):
            self.runs = list(runs)

        def geometric(self, _rate):
            return self.runs.pop(0) if self.runs else 10 ** 9

        def choice(self, n, size, replace):
            return np.array([0, 1])

        def random(self, n):
            return np.ones(n)  # never below MUTATION_RATE: no mutation

        def standard_normal(self, n):
            return np.zeros(n)

    host = jax_population(0, 4)
    leaves = [host[k] for k in convert.jax_leaf_order(host)]
    total = sum(leaf[0].size for leaf in leaves)
    first_leaf = leaves[0][0].size
    cut = first_leaf + max(1, leaves[1][0].size // 2)
    scores = np.array([1.0, 3.0, 0.5, 2.0])  # winners [2, 0]; losers [3, 1]
    evolved = pt_ensemble.evolve_model_ensemble(host, scores, ScriptedRng([cut, total - cut,
                                                                           total]))

    def flat(tree, member):
        return np.concatenate([tree[k][member].ravel() for k in convert.jax_leaf_order(tree)])

    pa, pb = flat(host, 2), flat(host, 0)
    child3 = flat(evolved, 3)
    np.testing.assert_array_equal(child3[:cut], pa[:cut])
    np.testing.assert_array_equal(child3[cut:], pb[cut:])
    assert cut > first_leaf
    np.testing.assert_array_equal(flat(evolved, 1), pa)


def test_evolution_skipped_for_small_population():
    host = {k: v[:2] for k, v in jax_population(0, 4).items()}
    pair = jax.tree.map(lambda x: x[:2], jax_tree(0, 4))
    assert jax_ensemble.evolve_model_ensemble(pair, np.array([1.0, 2.0]),
                                              np.random.default_rng(0)) is pair
    assert pt_ensemble.evolve_model_ensemble(host, np.array([1.0, 2.0]),
                                             np.random.default_rng(0)) is host
    ensemble = port_population(host, port_config(small_config()))
    assert pt_ensemble.evolve_ensemble_(ensemble, [1.0, 2.0], np.random.default_rng(0)) == []
    after = convert.params_to_jax(ensemble)
    assert all(np.array_equal(after[k], host[k]) for k in host)


def test_a_population_of_three_cannot_evolve_in_either_package():
    """Three members leave one winner, and a child needs two distinct
    parents: JAX's rng.choice raises, and so does the port, by name."""
    trio = jax.tree.map(lambda x: x[:3], jax_tree(0, 4))
    with pytest.raises(ValueError, match="larger sample"):
        jax_ensemble.evolve_model_ensemble(trio, np.array([1.0, 2.0, 3.0]),
                                           np.random.default_rng(0))
    with pytest.raises(ValueError, match="two distinct parents"):
        pt_ensemble.evolve_model_ensemble(convert.flatten_tree(trio), np.array([1.0, 2.0, 3.0]),
                                          np.random.default_rng(0))


# --- checkpoints and serving a member ----------------------------------------------------


def test_population_checkpoints_round_trip_and_serve_a_member(tmp_path):
    cfg = port_config(small_config(ensemble_size=4))
    ensemble, _ = pt_model.init_ensemble(torch.Generator().manual_seed(2), cfg.model, 4)
    manager = ckpt.create_checkpoint_manager(tmp_path / "ck", cfg)
    assert ckpt.save_checkpoint(manager, 5, ensemble, {}, force=True)
    on_disk = convert.load_npz(tmp_path / "ck" / "5" / "params.npz")
    one = convert.state_dict_to_jax(ensemble[0].state_dict())
    assert on_disk.keys() == one.keys()
    assert all(on_disk[k].shape == (4, *one[k].shape) for k in one)

    fresh, _ = pt_model.init_ensemble(torch.Generator().manual_seed(3), cfg.model, 4)
    bound = list(fresh.parameters())
    fresh, state, step = ckpt.restore_checkpoint(manager, fresh)
    assert step == 5 and state == {}
    assert all(a is b for a, b in zip(bound, fresh.parameters()))  # in place
    assert all(torch.equal(a, b) for a, b in zip(ensemble.parameters(), fresh.parameters()))

    for i in (0, 3):
        member, _ = pt_infer.load_newest_checkpoint(tmp_path / "ck", cfg, "cpu",
                                                    ensemble_size=4, ensemble_select=i)
        assert isinstance(member, pt_model.Model)
        assert all(torch.equal(a, b) for a, b in zip(ensemble[i].parameters(),
                                                     member.parameters()))
    whole, _ = pt_infer.load_newest_checkpoint(tmp_path / "ck", cfg, "cpu", ensemble_size=4,
                                               ensemble_select=None)
    assert isinstance(whole, pt_model.Ensemble) and len(whole) == 4
    with pytest.raises(ValueError, match="ensemble_size 2"):
        ckpt.restore_checkpoint(manager, pt_model.init_ensemble(torch.Generator(), cfg.model,
                                                                2)[0])
    with pytest.raises(RuntimeError):  # a population is not one member
        pt_infer.load_newest_checkpoint(tmp_path / "ck", cfg, "cpu")

    # A one-member checkpoint keeps its layout and loads as before.
    single, _ = pt_model.init(torch.Generator().manual_seed(4), cfg.model)
    ckpt.save_checkpoint(ckpt.create_checkpoint_manager(tmp_path / "one", cfg), 1, single, {},
                         force=True)
    flat = convert.load_npz(tmp_path / "one" / "1" / "params.npz")
    assert all(flat[k].shape == one[k].shape for k in one)
    loaded, _ = pt_infer.load_newest_checkpoint(tmp_path / "one", cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(single.parameters(), loaded.parameters()))
    with pytest.raises(ValueError, match="ensemble_size 4"):
        pt_infer.load_newest_checkpoint(tmp_path / "one", cfg, "cpu", ensemble_size=4)


# --- evaluation and the loop ------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ensemble")
    synthetic.make_synthetic_dataset(d, num_samples=2, duration_s=0.8, notes_per_sample=3,
                                     seed=5)
    return d


def test_ensemble_evaluation_matches_jax(dataset):
    cfg = loop_port_cfg()
    params = jax_tree(6, 3, LOOP_JAX_CFG.model)
    flat = convert.flatten_tree(params)
    ensemble = port_population(flat, cfg)
    rope = pt_model.make_rope(cfg.model)
    ours = pt_evaluate.compute_testset_loss_individual(ensemble, cfg, dataset, LOOP_FRAMES, rope)
    ref = jax_evaluate.compute_testset_loss_individual(
        params, LOOP_JAX_CFG, dataset, LOOP_FRAMES, jax_model.make_rope(LOOP_JAX_CFG.model),
        ensemble=True, generate_visualizations=False)
    assert sorted(ours) == sorted(ref)
    # The hit rate counts notes: equal.  The diffs are f32 sums over the
    # frames, taken in another order: relative 1e-5, as for one member
    # (tests/test_torch_train_entry.py).
    for name in ours:
        np.testing.assert_array_equal(ours[name]["hit_rate"], ref[name]["hit_rate"])
        for key in ("loss", "eventized_diff", "phantom_note_diff", "missed_note_diff"):
            assert ours[name][key].shape == (3,)
            np.testing.assert_allclose(ours[name][key], ref[name][key], rtol=1e-5, err_msg=key)
    # Member i alone, ensemble=False (the CLIs' call), is entry i.
    alone = pt_evaluate.compute_testset_loss_individual(ensemble[2], cfg, dataset, LOOP_FRAMES,
                                                        rope, ensemble=False)
    for name in ours:
        assert alone[name]["loss"].shape == (1,)
        assert alone[name]["loss"][0] == ours[name]["loss"][2]
    with pytest.raises(ValueError, match="select a member"):
        pt_evaluate.compute_testset_loss(ensemble, cfg, dataset, LOOP_FRAMES, rope,
                                         ensemble=False)


class _Writer:
    def __init__(self):
        self.scalars = []
        self.figures = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def add_figure(self, tag, figure, step):
        self.figures.append((tag, step))

    def flush(self):
        pass


def _batches(cfg, count, seed=0):
    rng = np.random.default_rng(seed)
    b, n = cfg.train.batch_size, cfg.data.samples_per_window
    for _ in range(count):
        audio = rng.standard_normal((b, 2, n)).astype(np.float32)
        labels = (rng.random((b, LOOP_FRAMES, 90)) > 0.95).astype(np.float32)
        yield labels, audio


def test_loop_with_evaluation_and_evolution(dataset, monkeypatch):
    """JAX's tests/test_loop_eval.py on the port: E = 4, 2 steps, evaluation
    and evolution at step 2.  The winners keep their bits, the losers
    change, in place; the optimizer stays bound with its moments; one more
    step moves the evolved weights."""
    cfg = loop_port_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ensemble_size=4, num_steps=2, testset_loss_every=2, print_every=1))
    ensemble, _ = pt_model.init_ensemble(torch.Generator().manual_seed(8), cfg.model, 4)
    opt = pt_optim.setup_optimizers(ensemble, cfg.model, cfg.train)
    bound = list(ensemble.parameters())
    seen = {}
    real = pt_loop.evolve_ensemble_

    def traced(model, scores, rng, mesh=None):
        seen["before"] = convert.params_to_jax(model)
        seen["moments"] = [t.clone() for chain in opt.members
                           for t in (chain._mu_flat, chain._nu_flat)]
        seen["scores"] = np.asarray(scores)
        seen["regenerated"] = real(model, scores, rng, mesh)
        seen["after"] = convert.params_to_jax(model)
        return seen["regenerated"]

    monkeypatch.setattr(pt_loop, "evolve_ensemble_", traced)
    writer, hooks = _Writer(), []
    pt_loop.train(cfg, ensemble, {}, opt, _batches(cfg, 2), None, pt_optim.schedule(cfg.train),
                  pt_model.make_rope(cfg.model), LOOP_FRAMES, testset_dirs={"synth": dataset},
                  summary_writer=writer, step_hook=lambda step, info: hooks.append(info))
    tags = {t for t, _, _ in writer.scalars}
    assert {"train/loss", "train/test-loss-synth"} <= tags
    losses = [v for t, v, _ in writer.scalars if t == "train/loss"]
    assert [h["loss"].shape for h in hooks] == [(4,), (4,)]
    assert losses == pytest.approx([float(np.min(h["loss"])) for h in hooks])
    test_losses = [v for t, v, _ in writer.scalars if t == "train/test-loss-synth"]
    assert test_losses == pytest.approx([seen["scores"][0]])  # member 0's, as in JAX

    order = list(np.argsort(seen["scores"]))
    assert seen["regenerated"] == [int(i) for i in order[2:]]
    before, after = seen["before"], seen["after"]
    for k in before:
        for winner in order[:2]:
            np.testing.assert_array_equal(after[k][winner], before[k][winner], err_msg=k)
    for loser in order[2:]:
        assert any(not np.array_equal(after[k][loser], before[k][loser]) for k in before)
    assert all(a is b for a, b in zip(bound, ensemble.parameters()))
    assert all(a is b for a, b in zip(bound, opt.params))
    moments = [t for chain in opt.members for t in (chain._mu_flat, chain._nu_flat)]
    assert all(torch.equal(a, b) for a, b in zip(seen["moments"], moments))
    assert opt.counts == [2, 2, 2, 2]
    final = convert.params_to_jax(ensemble)
    assert all(np.array_equal(final[k], after[k]) for k in final)

    step = pt_step.make_train_step(cfg, opt, pt_model.make_rope(cfg.model))
    labels, audio = next(_batches(cfg, 1, seed=9))
    mb = cfg.train.minibatch_size_per_device
    out = step(ensemble, pt_step.reshape_to_minibatches(torch.from_numpy(audio), mb),
               pt_step.reshape_to_minibatches(torch.from_numpy(labels), mb), 1.0)
    assert bool(out.grads_valid.all())
    moved = convert.params_to_jax(ensemble)
    for loser in order[2:]:
        assert any(not np.array_equal(moved[k][loser], after[k][loser]) for k in moved)


def _f16_cfg(**train):
    cfg = loop_port_cfg()
    return dataclasses.replace(
        cfg, precision=pt_config.PrecisionConfig("f32", "f16"),
        train=dataclasses.replace(cfg.train, ensemble_size=2, print_every=1,
                                  recovery_snapshot_every=1, **train))


def test_f16_loss_scaling_state_machine_over_a_population(caplog):
    """JAX's tests/test_train.py::test_f16_loss_scaling_state_machine at
    E = 2: a poisoned batch halves the grad scale and rolls every member
    back; clean batches below the threshold double it: 0.5 -> 1 -> 2 -> 4."""
    cfg = _f16_cfg(num_steps=4, loss_scale_increase_threshold=1e9)
    assert cfg.precision.needs_loss_scaling
    ensemble, _ = pt_model.init_ensemble(torch.Generator().manual_seed(4), cfg.model, 2)
    opt = pt_optim.setup_optimizers(ensemble, cfg.model, cfg.train)
    labels, audio = next(_batches(cfg, 1))

    def batches():
        yield labels, np.full_like(audio, np.nan)
        while True:
            yield labels, audio

    scales = {}
    with caplog.at_level(logging.WARNING):
        pt_loop.train(cfg, ensemble, {}, opt, batches(), None, pt_optim.schedule(cfg.train),
                      pt_model.make_rope(cfg.model), LOOP_FRAMES,
                      step_hook=lambda s, info: scales.__setitem__(s, info["grad_scale"]))
    assert "rolling back, grad scale 1.0 -> 0.5" in caplog.text
    assert scales == {2: 1.0, 3: 2.0, 4: 4.0}
    assert opt.counts == [3, 3]


def test_f16_rollback_takes_every_member_when_one_goes_non_finite(caplog, monkeypatch):
    """Member 1's decoder overflows f16 (its logits pass 65504), member 0's
    step is finite: both roll back to the snapshot (JAX's ``np.all``)."""
    cfg = _f16_cfg(num_steps=1)
    ensemble, _ = pt_model.init_ensemble(torch.Generator().manual_seed(4), cfg.model, 2)
    with torch.no_grad():
        ensemble[1].decoder.out.b.fill_(1e5)
    initial = convert.params_to_jax(ensemble)
    opt = pt_optim.setup_optimizers(ensemble, cfg.model, cfg.train)
    outs = []
    real = pt_loop.make_train_step

    def traced(*args):
        step = real(*args)
        return lambda *a: outs.append(step(*a)) or outs[-1]

    monkeypatch.setattr(pt_loop, "make_train_step", traced)
    with caplog.at_level(logging.WARNING):
        pt_loop.train(cfg, ensemble, {}, opt, _batches(cfg, 1), None,
                      pt_optim.schedule(cfg.train), pt_model.make_rope(cfg.model), LOOP_FRAMES)
    assert outs[0].grads_valid.tolist() == [True, False]
    assert "rolling back, grad scale 1.0 -> 0.5" in caplog.text
    final = convert.params_to_jax(ensemble)
    assert all(np.array_equal(final[k], initial[k]) for k in initial)
    assert opt.counts == [0, 0]
