"""The plain reference against the port's plain path at a tiny size: the
same function, computed independently."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import counters, weights
from portbench.reference import eventize as ref_eventize
from portbench.reference import frontend as ref_frontend
from portbench.reference import stitch as ref_stitch
from portbench.reference.model import Reference

from .conftest import TINY_MODEL


def _port_model():
    from audio_to_midi_tpu_torch.config import ModelConfig
    from audio_to_midi_tpu_torch.models import model as model_lib

    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in TINY_MODEL.items()},
                      attention_impl="xla", cnn_impl="xla")
    with torch.device("meta"):
        m = model_lib.Model(cfg)
    params = weights.make({k: tuple(v.shape) for k, v in m.state_dict().items()}, 3,
                          torch.device("cpu"))
    m = m.to_empty(device="cpu")
    m.load_state_dict(params)
    return model_lib, cfg, m.eval(), params


def test_forward_matches_the_port():
    model_lib, cfg, m, params = _port_model()
    x = torch.randn(3, 2, 80000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits, probs = model_lib.forward(m, cfg, x, model_lib.make_rope(cfg))
        ref_logits, ref_probs = Reference(params, dataclasses.asdict(cfg)).forward(x)
    scale = float(ref_logits.abs().max())
    assert float((logits - ref_logits).abs().max()) <= 5e-5 * scale
    assert float((probs - ref_probs).abs().max()) <= 2e-5


def test_every_block_reaches_the_output():
    """The layer scales the benchmark draws make a change in any block show:
    stage 5's last depthwise taps reversed move the probabilities far beyond
    the limit of f32 agreement."""
    model_lib, cfg, m, params = _port_model()
    x = torch.randn(2, 2, 80000, generator=torch.Generator().manual_seed(1))
    broken = dict(params)
    name = f"cnn.stages.5.blocks.{cfg.depths[5] - 1}.depth_conv.w"
    broken[name] = params[name].flip(0)
    with torch.no_grad():
        _, good = Reference(params, dataclasses.asdict(cfg)).forward(x)
        _, bad = Reference(broken, dataclasses.asdict(cfg)).forward(x)
    assert float((good - bad).abs().max()) > 1e-3


@pytest.mark.parametrize("seconds", [0.3, 6.0, 11.7])
def test_frontend_matches_the_port(seconds):
    from audio_to_midi_tpu_torch.ops.frontend import prepare_windows

    n = int(seconds * 44100)
    x = 0.3 * torch.randn(2, n, generator=torch.Generator().manual_seed(2))
    got = prepare_windows(x, 44100, 16000, 80000, 8000)
    want = ref_frontend.prepare(x, 44100, 16000, 80000, 8000)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5


def test_quiet_audio_is_not_scaled():
    x = torch.full((2, 100), 0.04)
    assert torch.equal(ref_frontend.normalize_loudness(x), x)


@pytest.mark.parametrize("count", [1, 2, 14])
def test_stitch_matches_the_port(count):
    from audio_to_midi_tpu_torch.ops.stitch import stitch_probs_parallel

    probs = torch.rand(count, 250, 90, generator=torch.Generator().manual_seed(count))
    got = stitch_probs_parallel(probs, 0.5, 5.0 / 250)
    want = ref_stitch.stitch(probs, 0.5, 5.0)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("frames", [1, 7, 250, 3000])
def test_eventizer_matches_the_port(frames):
    from audio_to_midi_tpu_torch.ops.eventize import extract_events

    rng = np.random.default_rng(frames)
    # smooth random curves that cross every threshold
    p = np.clip(np.cumsum(rng.normal(0, 0.08, (frames, 90)), axis=0) % 1.2, 0, 1)
    p = p.astype(np.float32)
    assert ref_eventize.events(p) == extract_events(torch.from_numpy(p))


def test_flop_counter_matches_torch():
    from torch.utils.flop_counter import FlopCounterMode

    _, cfg, _, params = _port_model()
    x = torch.randn(1, 2, 80000)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        Reference(params, dataclasses.asdict(cfg)).forward(x)
    assert fc.get_total_flops() == counters.forward_flops(dataclasses.asdict(cfg), 80000)


def test_attention_work_matches_torch():
    """The roofline's operation counts are the products the attention needs."""
    from torch.utils.flop_counter import FlopCounterMode

    g, s, heads, hd = 3, 50, 2, 8
    q, k, v = (torch.randn(g, s, heads, hd) for _ in range(3))
    with FlopCounterMode(display=False) as fc:
        w = torch.softmax(torch.einsum("gshd,gthd->ghst", q, k), -1)
        torch.einsum("ghst,gthd->gshd", w, v)
    assert counters.global_attention_work((g, s, heads * hd), 4)[0] == fc.get_total_flops()
    p, window = 64, 16
    windows = 2 * p // window - 1
    q, k, v = (torch.randn(g, windows, window, heads, hd) for _ in range(3))
    with FlopCounterMode(display=False) as fc:
        w = torch.softmax(torch.einsum("gnshd,gnthd->gnhst", q, k), -1)
        torch.einsum("gnhst,gnthd->gnshd", w, v)
    assert counters.local_attention_work((g, p, heads * hd), window, 4)[0] == fc.get_total_flops()
