"""The port's parallel/ package over several processes on the CPU (gloo),
without JAX: the ranks' harness and their jobs, which
tests/test_torch_parallel_vs_jax.py also runs and compares with the JAX
package; the lockstep ring against one rank's ring, dropout under data and
tensor parallelism, sharded serving against one rank, the multi-host
training CLI, the build-once barrier and the placement rules.

Every group of ranks is spawned, meets through a ``file://`` rendezvous in
its own directory, waits at most 60 s in any collective and is joined with
a deadline: a rank that never reaches a collective fails the test, it does
not hang it.  Children import this module and the port only.

Tolerances: sharded serving against one rank 1e-5 absolute on the stitched
probabilities (f32; the same products on fewer windows per call), events
identical; the ring's pool and batches bit for bit; replicated parameters
bit for bit across ranks after 3 steps with dropout.
"""

from __future__ import annotations

import copy
import multiprocessing as mp
import os
import re
import socket
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch import infer as pt_infer
from audio_to_midi_tpu_torch.data import device_ring, synthetic
from audio_to_midi_tpu_torch.models import attention as pt_attention
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.models import nn as a2m_nn
from audio_to_midi_tpu_torch.parallel import mesh as pmesh
from audio_to_midi_tpu_torch.parallel import tp as ptp
from audio_to_midi_tpu_torch.train import checkpoint as ckpt
from audio_to_midi_tpu_torch.train import ensemble as pt_ensemble
from audio_to_midi_tpu_torch.train import evaluate as pt_evaluate
from audio_to_midi_tpu_torch.train.optim import setup_optimizers
from audio_to_midi_tpu_torch.train.step import make_train_step, reshape_to_minibatches

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 150  # a group's deadline; any collective gives up after 60 s


# --- the harness -------------------------------------------------------------------


def _entry(job: str, rank: int, world: int, run: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{run}/rendezvous", rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
        payload = torch.load(Path(run, "payload.pt"), weights_only=False)
        out = globals()[job](payload, Path(run))
        torch.save(out, Path(run, f"out{rank}.pt"))
    except BaseException:
        Path(run, f"error{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(directory: Path, world: int, job, payload, timeout: float = JOIN_TIMEOUT_S):
    """``job(payload, run_dir)`` on ``world`` spawned ranks -> each rank's
    result, in rank order.  Kills the group and fails past ``timeout``."""
    run = directory / f"{job.__name__}_{world}_{time.monotonic_ns()}"
    run.mkdir(parents=True)
    torch.save(payload, run / "payload.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(job.__name__, r, world, str(run)), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    errors = {r: (run / f"error{r}.txt").read_text() for r in range(world)
              if (run / f"error{r}.txt").exists()}
    if hung or errors or any(p.exitcode != 0 for p in procs):
        pytest.fail(f"{job.__name__} on {world} ranks: hung {hung}, exit codes "
                    f"{[p.exitcode for p in procs]}\n" + "\n".join(errors.values()))
    return [torch.load(run / f"out{r}.pt", weights_only=False) for r in range(world)]


# --- the geometry ------------------------------------------------------------------

SAMPLES = 1280  # -> 128 frames: both attention kernels' routes, padding 0
OVERLAP = SAMPLES / 16000 / 2  # seconds: half a window


def tiny_cfg(dropout: float = 0.0, heads: int = 2, impl: str = "pallas",
             **train) -> pt_config.Config:
    """The JAX package's tests/test_parallel.py kernel geometry with one
    layer pair, f32."""
    train = {"batch_size": 16, "minibatch_size_per_device": 8, "warmup_steps": 0,
             "base_learning_rate": 1e-2, **train}
    return pt_config.Config(
        model=pt_config.ModelConfig(
            dims=(4, 8), depths=(1, 1), num_transformer_layers=1,
            num_transformer_heads=heads, attention_size=8, compressed_attention_kv_size=8,
            compressed_attention_q_size=8, rope_max_positions=256, attention_impl=impl,
            transformer_dropout_rate=dropout),
        data=pt_config.DataConfig(model_audio_length=SAMPLES / 16000),
        precision=pt_config.PrecisionConfig(compute_dtype="f32"),
        train=pt_config.TrainConfig(**train))


def batch(seed: int, cfg: pt_config.Config, n: int = 16):
    """Seeded audio (n, 2, N) and sparse labels (n, F, 90), f32 numpy."""
    rng = np.random.default_rng(seed)
    frames = cfg.model.output_frames(cfg.data.samples_per_window)
    audio = rng.standard_normal((n, 2, cfg.data.samples_per_window)).astype(np.float32)
    labels = (rng.random((n, frames, 90)) > 0.95).astype(np.float32)
    return audio, labels


def build(cfg: pt_config.Config, flat: dict, members: int = 1):
    """A port Model (or an Ensemble of ``members``) holding the full flat
    JAX layout ``flat`` (``(E,)``-leading for a population)."""
    if members == 1:
        model = pt_model.Model(cfg.model)
    else:
        model = pt_model.Ensemble(pt_model.Model(cfg.model) for _ in range(members))
    convert.load_params_(model, flat)
    return model


def seeded_flat(cfg: pt_config.Config, seed: int, members: int = 1) -> dict:
    model, _ = pt_model.init_ensemble(torch.Generator().manual_seed(seed), cfg.model, members)
    return convert.params_to_jax(model)


# --- the jobs (run in every rank) --------------------------------------------------


def jobs(payload, run) -> dict:
    """Several jobs in one group of ranks: {name: (job name, payload)}."""
    return {name: globals()[job](sub, run) for name, (job, sub) in payload.items()}


def layout_step(cfg, flat, layout, audio, labels, steps: int = 1, seed=None,
                minibatch: int = 8, record: bool = False) -> dict:
    """``steps`` train steps on the mesh ``layout`` = (ensemble, data,
    model) of the world: this rank's results, the full parameters after and
    the last step's gradients as the optimizer took them, in full layout."""
    e, _, m = layout
    mesh = pmesh.make_mesh(e, model_size=m)
    assert tuple(mesh.shape.values())[:3] == tuple(layout)[:len(mesh.shape)], mesh.shape
    model = pmesh.place_model(build(cfg, flat, e), mesh, cfg.model.num_transformer_heads)
    optimizer = setup_optimizers(model, cfg.model, cfg.train, mesh)
    step = make_train_step(cfg, optimizer, pt_model.make_rope(cfg.model), mesh)
    audio_mb, labels_mb = (pmesh.local_minibatches(
        reshape_to_minibatches(torch.from_numpy(x), minibatch), mesh) for x in (audio, labels))
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    grads, real_update = [], optimizer.update

    def update(step_grads, valid):
        # The gradients the optimizer takes: summed over "data", divided.
        grads[:] = [g.clone() for g in step_grads]
        return real_update(step_grads, valid)

    optimizer.update = update
    seeds, masks = [], []
    real_seed, real_mask = pt_attention.new_dropout_seed, a2m_nn.dropout_mask
    if record:
        def new_dropout_seed(*args, **kwargs):
            out = real_seed(*args, **kwargs)
            seeds.append(out.tolist())
            return out

        def dropout_mask(*args, **kwargs):
            out = real_mask(*args, **kwargs)
            masks.append(pmesh.param_digest([out]))
            return out

        pt_attention.new_dropout_seed, a2m_nn.dropout_mask = new_dropout_seed, dropout_mask
    try:
        losses = [step(model, audio_mb, labels_mb, 1.0, generator).loss.numpy().copy()
                  for _ in range(steps)]
    finally:
        pt_attention.new_dropout_seed, a2m_nn.dropout_mask = real_seed, real_mask
    params = {k: np.array(v) for k, v in pmesh.gather_params(model, mesh).items()}  # not views
    out = {"losses": losses, "params": params, "mesh": mesh.shape,
           "digest_all": pmesh.param_digest(list(model.parameters())),
           "digest_replicated": pmesh.param_digest(pmesh.replicated_params(model)),
           "seeds": seeds, "masks": masks}
    with torch.no_grad():  # the last step's gradients, gathered as the parameters are
        for p, g in zip(optimizer.params, grads, strict=True):
            p.copy_(g)
    return out | {"grads": pmesh.gather_params(model, mesh)}


def forward_job(payload, run) -> dict:
    """The TP 2 forward (and with "xla" and dropout, the single-rank mask),
    beside the same forward of one rank."""
    out = {}
    for name, cfg, enable_dropout in payload["forwards"]:
        mesh = pmesh.make_mesh(1, model_size=2)
        full = build(cfg, payload["flat"])
        single = copy.deepcopy(full)
        model = pmesh.place_model(full, mesh, cfg.model.num_transformer_heads)
        rope = pt_model.make_rope(cfg.model)
        audio = torch.from_numpy(payload["audio"])
        probs = []
        for m in (model, single):
            g = torch.Generator().manual_seed(5) if enable_dropout else None
            with torch.no_grad():
                probs.append(pt_model.forward(m, cfg.model, audio, rope, generator=g,
                                              enable_dropout=enable_dropout)[1].numpy())
        out[name] = {"tp": probs[0], "single": probs[1]}
    return out


def steps_job(payload, run) -> dict:
    return {name: layout_step(*args, **kwargs) for name, args, kwargs in payload["steps"]}


def optimizer_chain_job(payload, run) -> dict:
    """One optimizer update from the same full-layout ``grads`` on TP 2 and
    on one rank: the parameters after, in full layout.  Only the clip's
    norm crosses ranks."""
    cfg, flat = payload["cfg"], payload["flat"]
    out = {}
    for name, mesh in (("tp", pmesh.make_mesh(1, model_size=2)), ("single", None)):
        model = build(cfg, flat)
        if mesh is not None:
            model = pmesh.place_model(model, mesh, cfg.model.num_transformer_heads)
        optimizer = setup_optimizers(model, cfg.model, cfg.train, mesh)
        holder = copy.deepcopy(model)  # this rank's slices of the gradients
        convert.load_params_(holder, ptp.local_flat(model, payload["grads"]))
        grads = [p.detach().clone() for p in holder.parameters()]
        optimizer.apply(optimizer.update(grads, torch.ones((), dtype=torch.bool)))
        out[name] = convert.params_to_jax(model) if mesh is None else pmesh.gather_params(model,
                                                                                           mesh)
    return out


def ring_job(payload, run) -> dict:
    """The ring in mesh mode over this rank's feed: the pool after the
    lockstep pulls, and one sampled batch."""
    rank = dist.get_rank()
    mesh = pmesh.make_mesh(1)
    chunks = payload["feeds"][rank]
    feeder = device_ring._Feeder(iter(chunks))
    ring = device_ring.DeviceInputRing(payload["capacity"], payload["chunk"], mesh=mesh)
    ring.pull_lockstep(feeder, min_fill=payload["chunk"], refresh_chunks=0)
    first = ring.filled
    ring.pull_lockstep(feeder, min_fill=payload["chunk"], refresh_chunks=1)
    audio, labels = ring.sample(torch.Generator().manual_seed(3), payload["chunk"], 4, None)
    return {"first": first, "filled": ring.filled, "pool": ring._audio.clone(),
            "labels": ring._labels.clone(), "audio_mb": audio, "labels_mb": labels}


def serving_job(payload, run) -> dict:
    mesh = pmesh.make_mesh(1)
    cfg = payload["cfg"]
    model = build(cfg, payload["flat"]).eval()
    out = {}
    for per_batch in (128, 7):
        stitched, dpf, events = pt_infer.transcribe_file(
            model, cfg, payload["wav"], overlap=OVERLAP, max_windows_per_batch=per_batch,
            mesh=mesh)
        out[per_batch] = (stitched, dpf, events)
    return out


def ensemble_axis_job(payload, run) -> dict:
    """E = 4 on an ensemble axis of 4 (one member per rank) beside the
    in-process population on rank 0: one step, the evaluation, the
    evolution and a checkpoint."""
    cfg, flat = payload["cfg"], payload["flat"]
    audio, labels = payload["audio"], payload["labels"]
    mesh = pmesh.make_mesh(4)
    rope = pt_model.make_rope(cfg.model)
    frames = cfg.model.output_frames(cfg.data.samples_per_window)
    out = {}
    if mesh.rank == 0:
        population = build(cfg, flat, 4)
        step = make_train_step(cfg, setup_optimizers(population, cfg.model, cfg.train),
                               rope)
        mb = [reshape_to_minibatches(torch.from_numpy(x), 8) for x in (audio, labels)]
        ref = step(population, *mb, 1.0, torch.Generator().manual_seed(9))
        scores = pt_evaluate.compute_testset_loss(population, cfg, payload["testset"],
                                                  frames, rope)
        pt_ensemble.evolve_ensemble_(population, scores[0], np.random.default_rng(4))
        out["ref"] = {"loss": ref.loss.numpy(), "valid": ref.grads_valid.numpy(),
                      "scores": scores[0], "evolved": convert.params_to_jax(population)}
    member = pmesh.place_model(build(cfg, flat, 4), mesh, cfg.model.num_transformer_heads)
    step = make_train_step(cfg, setup_optimizers(member, cfg.model, cfg.train, mesh), rope,
                           mesh)
    mb = [reshape_to_minibatches(torch.from_numpy(x), 8) for x in (audio, labels)]
    got = step(member, *mb, 1.0, torch.Generator().manual_seed(9))
    loss = pt_evaluate.compute_testset_loss(member, cfg, payload["testset"], frames, rope)[0]
    scores = mesh.all_gather(torch.from_numpy(loss), pmesh.ENSEMBLE_AXIS).reshape(-1).numpy()
    regenerated = pt_ensemble.evolve_ensemble_(member, scores, np.random.default_rng(4), mesh)
    manager = ckpt.create_checkpoint_manager(run / "ck", cfg)
    ckpt.save_checkpoint(manager, 7, member, {}, force=True, mesh=mesh)
    out.update(loss=got.loss.numpy(), valid=got.grads_valid.numpy(), scores=scores,
               regenerated=regenerated, evolved=pmesh.gather_params(member, mesh),
               ck=str(run / "ck"))
    return out


# --- tests: rules and pieces in one process ----------------------------------------


def test_mesh_layout_rules():
    assert pmesh.mesh_layout(1, 8) == (("ensemble", "data"), (1, 8))
    assert pmesh.mesh_layout(2, 8, 2) == (("ensemble", "data", "model"), (2, 2, 2))
    with pytest.warns(UserWarning, match="does not divide"):
        assert pmesh.mesh_layout(3, 8)[1] == (1, 8)
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.mesh_layout(1, 8, 3)
    mesh = pmesh.Mesh(("ensemble", "data", "model"), (2, 2, 2), rank=6, build_groups=False)
    assert mesh.coords == {"ensemble": 1, "data": 1, "model": 0}
    assert (mesh.extent("data"), mesh.index("ensemble"), mesh.extent(None)) == (2, 1, 8)
    one = pmesh.make_mesh(1)
    assert one.shape == {"ensemble": 1, "data": 1} and one.size == 1 and not one._groups
    x = torch.arange(24.0).reshape(2, 4, 3)
    assert pmesh.local_minibatches(x, one) is x
    half = pmesh.Mesh(("ensemble", "data"), (1, 2), rank=1, build_groups=False)
    assert torch.equal(pmesh.local_minibatches(x, half), x[:, 2:])


def test_all_gather_bits_round_trip():
    """The gather's integer view gives every dtype's bits back."""
    for t in (torch.tensor([-0.0, 1.5, float("nan")]), torch.tensor([-0.0, 3.0]).half(),
              torch.tensor([1.0, -2.5]).bfloat16(), torch.tensor([True, False]),
              torch.tensor([-7, 2 ** 40]), torch.tensor([250, 3], dtype=torch.uint8)):
        back = pmesh._from_int_bits(pmesh._int_bits(t), t.dtype)
        assert back.dtype == t.dtype
        assert torch.equal(back.view(-1).view(torch.uint8) if t.dtype != torch.bool else back,
                           t.view(-1).view(torch.uint8) if t.dtype != torch.bool else t)


def test_shard_model_splits_heads_and_paired_ffn_units():
    cfg = tiny_cfg(heads=4)
    full = pt_model.Model(cfg.model, torch.Generator().manual_seed(0))
    flat = convert.params_to_jax(full)
    mesh = pmesh.Mesh(("ensemble", "data", "model"), (1, 1, 2), rank=1, build_groups=False)
    model = ptp.shard_params_tp(copy.deepcopy(full), mesh, 4)
    layer = model.transformer.layers[0].get_submodule("global")
    ref = full.transformer.layers[0].get_submodule("global")
    assert torch.equal(layer.attention.q_up.w, ref.attention.q_up.w[:, 16:])
    assert torch.equal(layer.attention.out.w, ref.attention.out.w[16:])
    assert torch.equal(layer.attention.kv_down.w, ref.attention.kv_down.w)
    inter = ref.ff.out_proj.w.shape[0]
    assert torch.equal(layer.ff.in_proj.w, torch.cat(
        [ref.ff.in_proj.w[:, inter // 2:inter], ref.ff.in_proj.w[:, inter + inter // 2:]], 1))
    assert torch.equal(layer.ff.out_proj.w, ref.ff.out_proj.w[inter // 2:])
    assert layer.attention.tp is model.tp and layer.ff.tp is model.tp
    assert model.decoder.out.w.shape == full.decoder.out.w.shape
    # The optimizer's moments are local; a copy of the model keeps its context.
    assert copy.deepcopy(model).tp is model.tp
    assert "transformer.layers.0.global.attention.q_up.w" in model.tp.sharded
    # Loading a full checkpoint into the shards.
    local = ptp.local_flat(model, flat)
    convert.load_params_(model, local)
    assert torch.equal(layer.ff.out_proj.w, ref.ff.out_proj.w[inter // 2:])
    with pytest.raises(ValueError, match="must divide"):
        ptp.shard_params_tp(pt_model.Model(tiny_cfg(heads=2).model),
                         pmesh.Mesh(("ensemble", "data", "model"), (1, 1, 4), rank=0,
                                    build_groups=False), 2)


def test_dropout_folds_keep_index_zero():
    from audio_to_midi_tpu_torch.train.step import fold_seed, minibatch_generator

    assert fold_seed(12345, 0) == 12345
    assert len({fold_seed(12345, i) for i in range(8)}) == 8
    assert all(0 <= fold_seed(2 ** 62 - 1, i) < 2 ** 62 for i in range(4))
    a = minibatch_generator(torch.Generator().manual_seed(1), torch.device("cpu"))
    b = minibatch_generator(torch.Generator().manual_seed(1), torch.device("cpu"), 0)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    mesh = pmesh.Mesh(("ensemble", "data", "model"), (1, 1, 2), rank=1, build_groups=False)
    tp = ptp.TensorParallel(mesh, frozenset(), {})
    seed = torch.tensor([5, 7], dtype=torch.int32)
    assert not torch.equal(tp.fold_seed(seed), seed) and (tp.fold_seed(seed) >= 0).all()
    tp0 = ptp.TensorParallel(pmesh.Mesh(("ensemble", "data", "model"), (1, 1, 2), rank=0,
                                        build_groups=False), frozenset(), {})
    assert tp0.fold_seed(seed) is seed


def test_build_once_barrier_builds_on_rank_zero_only(monkeypatch):
    from audio_to_midi_tpu_torch.cli import train_cli
    from audio_to_midi_tpu_torch.ops import cuda_build

    for rank in (0, 1, 3):
        calls = []
        monkeypatch.setattr(cuda_build, "build", lambda: calls.append("build"))
        mesh = SimpleNamespace(rank=rank, barrier=lambda: calls.append("barrier"))
        train_cli._build_kernels_once(mesh)
        assert calls == (["build", "barrier"] if rank == 0 else ["barrier"])


class _FakeFeeder:
    def __init__(self, items, exhausted=False):
        self.items, self.exhausted = list(items), exhausted

    def get(self, block):
        return self.items.pop(0) if self.items else None


def test_pull_lockstep_errors():
    mesh = pmesh.Mesh(("ensemble", "data"), (1, 2), rank=0, build_groups=False)
    with pytest.raises(ValueError, match="chunk of 3 windows does not divide over 2 processes"):
        device_ring.DeviceInputRing(8, 3, mesh=mesh)
    ring = device_ring.DeviceInputRing(8, 4, mesh=mesh)
    with pytest.raises(RuntimeError, match="exhausted before any batch"):
        ring.pull_lockstep(_FakeFeeder([], exhausted=True), min_fill=4, refresh_chunks=0)
    with pytest.raises(RuntimeError, match="produced nothing for ~600 s"):
        ring.pull_lockstep(_FakeFeeder([]), min_fill=4, refresh_chunks=0)
    small = (torch.zeros(1, 2, 8, dtype=torch.float16), torch.zeros(1, 3, 4, dtype=torch.float16))
    with pytest.raises(ValueError, match="local chunks of 2"):
        ring.pull_lockstep(_FakeFeeder([small]), min_fill=4, refresh_chunks=0)
    with pytest.raises(ValueError, match="a push takes 4 windows, got 6"):
        ring.push(np.zeros((3, 2, 8), np.float16), np.zeros((3, 3, 4), np.float16))


# --- tests: groups of ranks --------------------------------------------------------


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One group of 2 ranks: the lockstep ring, dropout under DP 2 and TP 2,
    and sharded serving."""
    tmp = tmp_path_factory.mktemp("pair")
    rng = np.random.default_rng(0)
    # Each rank's feed: three (events, audio) chunks of 2 local windows.
    feeds = [[(rng.random((2, 3, 4)).astype(np.float16),
               rng.standard_normal((2, 2, 8)).astype(np.float16)) for _ in range(3)]
             for _ in range(2)]
    cfg = tiny_cfg(dropout=0.1)
    flat = seeded_flat(cfg, 0)
    audio, labels = batch(1, cfg)
    synthetic.make_synthetic_dataset(tmp / "wav", num_samples=1, duration_s=1.0,
                                     notes_per_sample=3, seed=2)
    wav = sorted((tmp / "wav").glob("*.wav"))[0]
    serve_cfg = tiny_cfg()
    steps = [(name, (cfg, flat, layout, audio, labels), {"steps": 3, "seed": 11,
                                                         "record": True})
             for name, layout in (("dp", (1, 2, 1)), ("tp", (1, 1, 2)))]
    grad_rng = np.random.default_rng(8)
    grads = {k: grad_rng.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()}
    ranks = run_ranks(tmp, 2, jobs, {
        "ring": ("ring_job", {"feeds": feeds, "capacity": 8, "chunk": 4}),
        "chain": ("optimizer_chain_job", {"cfg": tiny_cfg(global_norm_clip=0.1), "flat": flat,
                                           "grads": grads}),
        "dropout": ("steps_job", {"steps": steps}),
        "serving": ("serving_job", {"cfg": serve_cfg, "flat": flat, "wav": str(wav)})})
    return {name: [r[name] for r in ranks] for name in ("ring", "dropout", "serving",
                                                        "chain")} | {
        "feeds": feeds, "serve_cfg": serve_cfg, "flat": flat, "wav": wav}


def test_ring_lockstep_matches_one_rank(pair):
    """Two ranks, each with its own feed: the pool is the one rank's pool of
    the concatenated feeds, and each rank samples its "data" slice of the
    batch one rank samples under the same generator."""
    feeds = pair["feeds"]
    one = device_ring.DeviceInputRing(8, 4)
    for (l0, a0), (l1, a1) in list(zip(*feeds))[:2]:
        one.push(np.concatenate([a0, a1]), np.concatenate([l0, l1]))
    audio, labels = one.sample(torch.Generator().manual_seed(3), 4, 4, None)
    for rank, got in enumerate(pair["ring"]):
        assert (got["first"], got["filled"]) == (4, 8)
        assert torch.equal(got["pool"], one._audio) and torch.equal(got["labels"], one._labels)
        assert torch.equal(got["audio_mb"], audio[:, 2 * rank:2 * rank + 2])
        assert torch.equal(got["labels_mb"], labels[:, 2 * rank:2 * rank + 2])


def test_dropout_under_data_and_tensor_parallelism(pair):
    dp, tp = ([r[name] for r in pair["dropout"]] for name in ("dp", "tp"))
    for runs in (dp, tp):
        assert all(np.isfinite(loss).all() for r in runs for loss in r["losses"])
        # Replicated state bit for bit after 3 steps with dropout.
        assert runs[0]["digest_replicated"] == runs[1]["digest_replicated"]
        assert [loss.tolist() for loss in runs[0]["losses"]] == [
            loss.tolist() for loss in runs[1]["losses"]]
        assert runs[0]["seeds"] and runs[0]["masks"]
    assert dp[0]["digest_all"] == dp[1]["digest_all"]
    assert tp[0]["digest_all"] != tp[1]["digest_all"]  # the shards
    # The data ranks' masks differ; the model ranks' attention seeds differ
    # and their FFN masks (on the replicated output) are equal.
    assert dp[0]["masks"] != dp[1]["masks"] and dp[0]["seeds"] != dp[1]["seeds"]
    assert all(a != b for a, b in zip(tp[0]["seeds"], tp[1]["seeds"]))
    assert tp[0]["masks"] == tp[1]["masks"]
    np.testing.assert_array_equal(tp[0]["params"]["decoder/out/w"],
                                  tp[1]["params"]["decoder/out/w"])


def test_tp_optimizer_chain_matches_one_rank(pair):
    """The same gradients through the optimizer on TP 2 and on one rank,
    with the clip active (0.1): every update within 1e-6 of its leaf's
    largest (measured bit for bit).  A clip norm that missed the sharded
    squares of the other rank, or counted the replicated ones twice, would
    scale every update by another factor."""
    flat = pair["flat"]
    for rank in pair["chain"]:
        largest = 0.0
        for k in flat:
            upd_tp, upd = rank["tp"][k] - flat[k], rank["single"][k] - flat[k]
            largest = max(largest, float(np.abs(upd).max()))
            np.testing.assert_allclose(upd_tp, upd, rtol=0, atol=1e-6 * float(np.abs(upd).max()),
                                       err_msg=k)
        assert 0 < largest < 5e-3  # lr 1e-2, warm-up 0: unclipped, the largest is ~1e-2


def test_sharded_serving_matches_one_rank(pair):
    cfg = pair["serve_cfg"]
    model = build(cfg, pair["flat"]).eval()
    for per_batch in (128, 7):
        stitched, dpf, events = pt_infer.transcribe_file(
            model, cfg, pair["wav"], overlap=OVERLAP, max_windows_per_batch=per_batch)
        for rank in pair["serving"]:
            got, got_dpf, got_events = rank[per_batch]
            assert got.shape == stitched.shape and got_dpf == dpf
            np.testing.assert_allclose(got, stitched, rtol=0, atol=1e-5)
            assert got_events == events
    np.testing.assert_array_equal(pair["serving"][0][7][0], pair["serving"][1][7][0])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_cli(tmp: Path, cfg_path: Path, ck: Path, steps: int) -> list[str]:
    """Two train_cli processes on the CPU -> each rank's log."""
    port = _free_port()
    env = {**os.environ, "A2M_DISABLE_NATIVE": "1", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(REPO)}
    paths = [tmp / f"rank{rank}_{port}.log" for rank in range(2)]
    procs = []
    try:
        for rank, path in enumerate(paths):
            with open(path, "w") as out:  # a file: a full pipe cannot stall a rank
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "audio_to_midi_tpu_torch.cli.train_cli", "--dataset",
                     str(tmp / "train"), "--config", str(cfg_path), "--checkpoint", str(ck),
                     "--steps", str(steps), "--no-tensorboard", "--device", "cpu",
                     "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", "2",
                     "--process-id", str(rank)],
                    cwd=tmp, env=env, stdout=out, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.wait(max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [path.read_text() for path in paths]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-6000:]
    return logs


def test_multihost_train_cli_on_two_processes(tmp_path):
    """--coordinator-address / --num-processes / --process-id: two ranks of
    DP 2 on a synthetic set, the same parameters at the end, one checkpoint
    writer, and a resume at latest + 1."""
    synthetic.make_synthetic_dataset(tmp_path / "train", num_samples=2, duration_s=0.8,
                                     notes_per_sample=3, seed=5)
    cfg = tiny_cfg(batch_size=4, minibatch_size_per_device=2, checkpoint_every=2,
                   input_ring_capacity=8, dataset_num_workers=1, print_every=1)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(pt_config.config_to_json(cfg))
    ck = tmp_path / "ck"
    digest = re.compile(r"parameter digest (\d+)")
    logs = _train_cli(tmp_path, cfg_path, ck, 2)
    assert [len(digest.findall(log)) for log in logs] == [1, 1]
    assert digest.findall(logs[0]) == digest.findall(logs[1])
    assert "Training on 2 device(s), batch 4, minibatch 4" in logs[0]
    assert sorted(p.name for p in ck.iterdir() if p.name.isdigit()) == ["2"]
    assert not list(ck.glob(".*tmp*"))
    logs = _train_cli(tmp_path, cfg_path, ck, 3)
    assert all("Restored checkpoint at step 2" in log for log in logs)
    assert all("step 3/3" in log and "step 2/3" not in log for log in logs)
    assert digest.findall(logs[0]) == digest.findall(logs[1])
    assert sorted(p.name for p in ck.iterdir() if p.name.isdigit()) == ["2", "3"]
