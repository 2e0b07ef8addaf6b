"""Training driver: ``train/loop.train`` as ``cli/train_cli.py`` builds it,
fed by the threaded loader through the device ring, with augmentation on
the card.

Set-up: the kernels (built or loaded), a seeded synthetic dataset (made
once per checkout under ``portbench/.cache/``), the model with the seed's
weights, its optimizer and the loader.  Then one call to ``loop.train``
runs the whole run: its first ``warm_steps`` steps are set-up (the ring's
first fill, every kernel's first launch), and the first ``check_steps`` of
them are the steps the output check follows.  The window opens at the
next step and closes at the first step that would start after ``seconds``;
the steps launched in it count once the card has finished them.  A
``--trace 1`` run then traces ``trace_steps`` more steps.  The loop is
left by an exception from the benchmark's wrapper of its step, the one
exit the loop offers short of its step count.

The wrapper (:class:`_Watch`) reads what the check needs from the same
objects the window goes on to train: the rows each checked step trained on
(sampled from the ring and augmented), each attention call's dropout seed
and each feed-forward mask as the program draws them, each step's loss,
the first gradient from the optimizer's moments after one step, and the
parameters' change after ``check_steps`` steps.  The plain reference
(``reference/train.py``) follows the same steps from the benchmark's
weights once the window has closed and the program's state is freed.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import os
import shutil
import time

import torch

from .. import check, generate, manifest, trace, weights
from .serve import port_config

log = logging.getLogger("portbench")

SPANS = ("train_step",)


class _WindowClosed(Exception):
    """Leaves ``loop.train`` once the window (and the trace) are done."""


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dataset(mix: dict):
    """The mix's synthetic dataset, made once per checkout at a fixed path."""
    from audio_to_midi_tpu_torch.data.synthetic import make_synthetic_dataset

    d = mix["dataset"]
    path = manifest.BENCH / ".cache" / "data" / (
        f"synthetic-{d['files']}x{d['file_s']}s-{d['notes_per_file']}n-{d['seed']}")
    if (path / "complete").exists():
        return path
    partial = path.with_name(path.name + ".partial")
    shutil.rmtree(partial, ignore_errors=True)
    make_synthetic_dataset(partial, num_samples=d["files"], duration_s=d["file_s"],
                           notes_per_sample=d["notes_per_file"], seed=d["seed"], variety=True)
    (partial / "complete").write_text("")
    shutil.rmtree(path, ignore_errors=True)
    partial.rename(path)
    return path


def _train_config(config: dict, mix: dict):
    from audio_to_midi_tpu_torch.config import TrainConfig

    cfg = port_config(config)
    opt = mix["optimizer"]
    train = TrainConfig(
        batch_size=mix["batch"], minibatch_size_per_device=mix["minibatch"],
        num_steps=opt["num_steps"], warmup_steps=opt["warmup_steps"],
        base_learning_rate=opt["base_learning_rate"], layer_lr_decay=opt["layer_lr_decay"],
        weight_decay=opt["weight_decay"], adam_b1=opt["adam_b1"], adam_b2=opt["adam_b2"],
        adam_eps=opt["adam_eps"], global_norm_clip=opt["global_norm_clip"],
        print_every=10 ** 9, testset_loss_every=10 ** 9,
        dataset_num_workers=mix["loader_workers"],
        input_ring_capacity=mix["ring_capacity"],
        input_ring_refresh_period=mix["ring_refresh_period"])
    return dataclasses.replace(cfg, train=train)


class _Watch:
    """The loop's training step, wrapped: it records what the check needs
    in the first steps, opens and closes the window, and ends the loop."""

    def __init__(self, make_train_step, mix: dict, seconds: float, traced: bool,
                 device: torch.device, initial: dict):
        self._make = make_train_step
        self.mix, self.seconds, self.traced, self.device = mix, seconds, traced, device
        self.initial = initial          # the benchmark's weights, on the host
        self.steps = 0
        self.window_steps = 0
        self.valid = []
        self.t_start = self.t_end = None
        self.rows = []                  # per checked step: (audio, labels) on the host
        self.draws = []                 # per checked step, per minibatch: the dropout draws
        self.loss = []
        self.grad_norms = self.change_norms = None
        self.profiler = None
        self.trace_left = 0

    def make_train_step(self, cfg, optimizer, rope, mesh=None):
        step = self._make(cfg, optimizer, rope, mesh)
        names = optimizer.names

        def watched(model, audio, labels, grad_scale, generator=None):
            self.steps += 1
            n = self.steps
            if n == 2:
                b1 = cfg.train.adam_b1
                self.grad_norms = {k: float(m.norm()) / (1.0 - b1)
                                   for k, m in zip(names, optimizer.mu)}
            if n == self.mix["check_steps"] + 1:
                self.change_norms = {k: float((p.detach().cpu() - self.initial[k]).norm())
                                     for k, p in zip(names, optimizer.params)}
            if n == self.mix["warm_steps"] + 1:
                self._open()
            elif self.t_start is not None:
                self._maybe_close()
            if n <= self.mix["check_steps"]:
                return self._checked(step, model, audio, labels, grad_scale, generator)
            if self.profiler is not None:
                with torch.profiler.record_function("train_step"):
                    return step(model, audio, labels, grad_scale, generator)
            out = step(model, audio, labels, grad_scale, generator)
            if self.t_end is None and self.t_start is not None:
                self.window_steps += 1
                self.valid.append(out.grads_valid)
            return out

        return watched

    def _open(self) -> None:
        _sync(self.device)
        gc.collect()
        gc.freeze()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t_start = time.perf_counter()
        log.info("set-up: %d steps; the window opens", self.steps - 1)

    def _maybe_close(self) -> None:
        if self.t_end is None:
            if time.perf_counter() - self.t_start < self.seconds:
                return
            _sync(self.device)
            self.t_end = time.perf_counter()
            log.info("window: %d steps in %.2f s", self.window_steps, self.t_end - self.t_start)
            self.peak = (torch.cuda.max_memory_allocated(self.device)
                         if self.device.type == "cuda" else 0)
            if self.traced:
                self._start_trace()
                return
            raise _WindowClosed
        if self.profiler is not None:
            self.trace_left -= 1
            if self.trace_left <= 0:
                _sync(self.device)
                self._range.__exit__(None, None, None)
                self.profiler.__exit__(None, None, None)
                raise _WindowClosed

    def _start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=activities, record_shapes=True)
        self.profiler.__enter__()
        self._range = record_function(trace.WINDOW)
        self._range.__enter__()
        self.trace_left = self.mix["trace_steps"]

    def _checked(self, step, model, audio, labels, grad_scale, generator):
        """A checked step, with the dropout draws recorded as they are made."""
        from audio_to_midi_tpu_torch.models import attention
        from audio_to_midi_tpu_torch.models import nn as a2m_nn

        draws = []
        real_seed, real_mask = attention.new_dropout_seed, a2m_nn.dropout_mask

        def seed(*a, **k):
            s = real_seed(*a, **k)
            draws.append(("seed", s.cpu()))
            return s

        def mask(*a, **k):
            m = real_mask(*a, **k)
            draws.append(("mask", m.cpu()))
            return m

        attention.new_dropout_seed, a2m_nn.dropout_mask = seed, mask
        try:
            out = step(model, audio, labels, grad_scale, generator)
        finally:
            attention.new_dropout_seed, a2m_nn.dropout_mask = real_seed, real_mask
        per_mb = len(draws) // audio.shape[0]
        self.draws.append([draws[i * per_mb: (i + 1) * per_mb] for i in range(audio.shape[0])])
        self.rows.append((audio.detach().cpu(), labels.detach().cpu()))
        self.loss.append(float(out.loss))
        if not bool(out.grads_valid):
            raise RuntimeError(f"checked step {self.steps} was not finite")
        return out


def program(config: dict, mix: dict, seed: int, seconds: float, traced: bool,
            device: torch.device) -> tuple[dict, dict]:
    """The program's part of a run: set-up, the checked and warm steps, the
    window and the trace.  Returns (what the run measured, what the check
    needs: the program's observations, the rows, the draws and the
    benchmark's weights), the program's state freed.

    The loader's window memo (``A2M_WINDOW_MEMO_BYTES``, read when the
    loader is first imported) is sized to hold the whole dataset, so that
    after the warm steps no window is decoded again: below it the threads
    re-decode evicted files all through the window, and the runs' rates
    swung by a third."""
    os.environ["A2M_WINDOW_MEMO_BYTES"] = str(mix["window_memo_bytes"])
    from audio_to_midi_tpu_torch.data import loader as loader_lib
    from audio_to_midi_tpu_torch.models import model as model_lib
    from audio_to_midi_tpu_torch.ops import cuda_build
    from audio_to_midi_tpu_torch.train import loop
    from audio_to_midi_tpu_torch.train.optim import schedule, setup_optimizers

    t0 = time.perf_counter()
    if device.type == "cuda":
        cuda_build.library()
    t1 = time.perf_counter()
    data_dir = dataset(mix)
    t2 = time.perf_counter()
    cfg = _train_config(config, mix)
    with torch.device("meta"):
        model = model_lib.Model(cfg.model)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    params = weights.make(shapes, seed, device)
    weights.set_label_prior(params, mix["label_prior"])
    model = model.to_empty(device=device)
    model.load_state_dict(params)
    model.train()
    initial = {k: v.cpu() for k, v in params.items()}
    del params
    optimizer = setup_optimizers(model, cfg.model, cfg.train)
    rope = model_lib.make_rope(cfg.model, device)
    num_frames = cfg.model.output_frames(cfg.data.samples_per_window)
    order, draws = generate.seed_ints(seed, 2, salt=6)
    loader = loader_lib.create_dataset_loader(
        data_dir, batch_size=cfg.train.batch_size, num_workers=cfg.train.dataset_num_workers,
        num_epochs=100_000, sample_rate=cfg.data.sample_rate,
        duration=cfg.data.model_audio_length, output_divisions=num_frames,
        transform_settings=None, use_grain=False, threaded_seed=order % 2 ** 32)
    generator = torch.Generator().manual_seed(draws)
    log.info("set-up: kernels %.2f s, dataset %.2f s, model and loader %.2f s (window memo "
             "%d bytes)", t1 - t0, t2 - t1, time.perf_counter() - t2,
             loader_lib._WINDOW_MEMO_BUDGET)

    watch = _Watch(loop.make_train_step, mix, seconds, traced, device, initial)
    loop.make_train_step = watch.make_train_step
    try:
        loop.train(cfg, model, {}, optimizer, loader, None, schedule(cfg.train), rope,
                   num_frames, num_steps=10 ** 9, generator=generator)
        raise RuntimeError("the training loop ended before the window closed")
    except _WindowClosed:
        pass
    finally:
        loop.make_train_step = watch._make
        loader.close()
        gc.unfreeze()
    steps = watch.window_steps
    measured = {
        "steps": steps,
        "windows": steps * cfg.train.batch_size,
        "failed": int((~torch.stack(watch.valid)).sum()) if watch.valid else 0,
        "t_start": watch.t_start,
        "window_s": watch.t_end - watch.t_start,
        "peak": watch.peak,
        "trace": trace.summarize(watch.profiler, SPANS, ()) if traced else None,
    }
    observed = {"program": {"loss": watch.loss, "grad_norms": watch.grad_norms,
                            "change_norms": watch.change_norms},
                "rows": watch.rows, "draws": watch.draws, "initial": initial}
    del model, optimizer, loader, watch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return measured, observed


def run(config: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, t_process: float) -> dict:
    """One run of a training cell."""
    m, o = program(config, mix, seed, seconds, traced, device)
    t0 = time.perf_counter()
    values = check.train_readings(o["program"], o["rows"], o["draws"], o["initial"], config,
                                  mix, device)
    log.info("output check: the reference's %d steps in %.1f s", len(o["rows"]),
             time.perf_counter() - t0)
    correct, checks = check.judge(values["program"], config["check"]["train"], m["failed"])
    return {
        "correct": correct and m["steps"] > 0,
        "attempted": m["steps"],
        "failed": m["failed"],
        "end_to_end": {"train_windows_per_s": m["windows"] / m["window_s"],
                       "setup_s": m["t_start"] - t_process},
        "counters": {"windows": m["windows"], "steps": m["steps"], "window_s": m["window_s"]},
        "spans": None,
        "trace": m["trace"],
        "memory_peak_bytes": m["peak"],
        "checks": checks,
        "sample": [],
    }
