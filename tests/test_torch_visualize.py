"""``utils/visualize.py`` and the figures built on it, against the JAX
package's: each figure's drawn arrays, titles and labels on the same inputs
(the port's from tensors), the metrics' figure, the evaluation's figure
list, ``--visualize-audio`` of the serving CLI and ``--visualize`` of the
dataset harness.  The Agg backend is set before pyplot is imported, so that
``plt.show(block=True)`` returns."""


import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from audio_to_midi_tpu import metrics as jax_metrics  # noqa: E402
from audio_to_midi_tpu.models import model as jax_model  # noqa: E402
from audio_to_midi_tpu.train import evaluate as jax_evaluate  # noqa: E402
from audio_to_midi_tpu.utils import visualize as jax_visualize  # noqa: E402
from audio_to_midi_tpu_torch import config as pt_config  # noqa: E402
from audio_to_midi_tpu_torch import convert  # noqa: E402
from audio_to_midi_tpu_torch import metrics as pt_metrics  # noqa: E402
from audio_to_midi_tpu_torch.cli import audio_to_midi as pt_cli  # noqa: E402
from audio_to_midi_tpu_torch.data import __main__ as data_main  # noqa: E402
from audio_to_midi_tpu_torch.data import synthetic  # noqa: E402
from audio_to_midi_tpu_torch.data.loader import resolve_audio_file  # noqa: E402
from audio_to_midi_tpu_torch.models import model as pt_model  # noqa: E402
from audio_to_midi_tpu_torch.train import evaluate as pt_evaluate  # noqa: E402
from audio_to_midi_tpu_torch.utils import visualize  # noqa: E402
from tests.test_torch_train_loop import FRAMES, JAX_CFG, port_cfg  # noqa: E402

torch.set_num_threads(2)


def describe(fig) -> list:
    """What a figure draws: per axes its title, labels, limits, lines' data
    and collections' arrays."""
    out = []
    for ax in fig.axes:
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
            "lines": [(line.get_label(), line.get_xydata()) for line in ax.lines],
            "collections": [np.asarray(c.get_array()) for c in ax.collections
                            if c.get_array() is not None],
        })
    return out


def assert_same(ours, ref, atol=0.0):
    a, b = describe(ours), describe(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for key in ("title", "xlabel", "ylabel"):
            assert x[key] == y[key], key
        np.testing.assert_allclose(x["xlim"], y["xlim"], rtol=0, atol=atol)
        np.testing.assert_allclose(x["ylim"], y["ylim"], rtol=0, atol=atol)
        assert [n for n, _ in x["lines"]] == [n for n, _ in y["lines"]]
        for (_, p), (_, q) in zip(x["lines"], y["lines"]):
            np.testing.assert_allclose(p, q, rtol=0, atol=atol)
        assert len(x["collections"]) == len(y["collections"])
        for p, q in zip(x["collections"], y["collections"]):
            np.testing.assert_allclose(p, q, rtol=0, atol=atol)


@pytest.fixture(autouse=True)
def close_figures():
    plt.close("all")
    yield
    plt.close("all")


rng = np.random.default_rng(31)
SAMPLES = rng.standard_normal((2, 4000)).astype(np.float32)
PROBS = rng.random((60, 90)).astype(np.float32)
FIGURES = {
    "plot_output_probs": (("song.wav", 0.02), (PROBS,)),
    "plot_time_domain_audio": ((16000,), (SAMPLES[0],)),
    "plot_frequency_domain_audio": (("song.wav",), (SAMPLES,)),
    "plot_prob_dist": (("velocity",), (PROBS[0],)),
    "plot_embedding": (("song.wav",), (PROBS[:, :16],)),
    "visualize_sample": (("song.wav",), (SAMPLES, PROBS)),
}


@pytest.mark.parametrize("name", list(FIGURES))
def test_each_figure_draws_what_jax_draws(name):
    plain, arrays = FIGURES[name]
    ref = getattr(jax_visualize, name)(*plain, *arrays)
    ours = getattr(visualize, name)(*plain, *(torch.from_numpy(a) for a in arrays))
    assert_same(ours, ref)


def test_frequency_domain_figure_with_events_and_a_bf16_tensor():
    ref = jax_visualize.plot_frequency_domain_audio("x", SAMPLES, events=PROBS)
    ours = visualize.plot_frequency_domain_audio("x", torch.from_numpy(SAMPLES),
                                                 events=torch.from_numpy(PROBS).bfloat16())
    assert_same(ours, jax_visualize.plot_frequency_domain_audio(
        "x", SAMPLES, events=torch.from_numpy(PROBS).bfloat16().float().numpy()))
    assert len(describe(ref)) == len(describe(ours)) == 3  # two panels and the colorbar


def test_metrics_figure_matches_jax():
    expected = (rng.random((65, 90)) > 0.9).astype(np.float32)
    ours = pt_metrics.detailed_event_loss(PROBS, expected, generate_visualization=True)
    ref = jax_metrics.detailed_event_loss(PROBS, expected, generate_visualization=True)
    assert ours.full_diff == pytest.approx(ref.full_diff, rel=1e-5)  # f32 sums in another order
    assert_same(ours.visualization, ref.visualization)
    assert pt_metrics.detailed_event_loss(PROBS, expected).visualization is None


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("visualize")
    synthetic.make_synthetic_dataset(d, num_samples=2, duration_s=0.8, notes_per_sample=3,
                                     seed=5)
    return d


def test_evaluation_figures_match_jax(dataset):
    """One figure per sample and member by default (fewer than 30 samples),
    as JAX's; none when asked for none."""
    cfg = port_cfg()
    params, _ = jax_model.init(jax.random.PRNGKey(3), JAX_CFG.model)
    model = pt_model.Model(cfg.model)
    model.load_state_dict(convert.jax_to_state_dict(
        convert.flatten_tree(jax.tree.map(np.asarray, params))))
    rope = pt_model.make_rope(cfg.model)
    ours = pt_evaluate.compute_testset_loss(model.eval(), cfg, dataset, FRAMES, rope,
                                            ensemble=False)[3]
    ref = jax_evaluate.compute_testset_loss(params, JAX_CFG, dataset, FRAMES,
                                            jax_model.make_rope(JAX_CFG.model),
                                            ensemble=False)[3]
    assert len(ours) == len(ref) == 2
    for mine, theirs in zip(ours, ref):
        assert_same(mine, theirs, atol=1e-5)  # the probabilities: f32 sums in another order
    assert pt_evaluate.compute_testset_loss(model, cfg, dataset, FRAMES, rope, ensemble=False,
                                            generate_visualizations=False)[3] == []


def test_visualize_audio_draws_each_window_and_the_stitched_probabilities(dataset, tmp_path,
                                                                         capsys):
    cfg = port_cfg()
    model = pt_model.Model(cfg.model, torch.Generator().manual_seed(4))
    convert.save_npz(tmp_path / "params.npz", convert.state_dict_to_jax(model.state_dict()))
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(pt_config.config_to_json(cfg))
    wav = resolve_audio_file(dataset / "sample_000")
    argv = [str(wav), str(tmp_path / "out.mid"), "--checkpoint", str(tmp_path / "params.npz"),
            "--config", str(cfg_path), "--device", "cpu", "--overlap", "0.1"]
    assert pt_cli.main(argv + ["--visualize-audio"]) == 0
    out = capsys.readouterr().out
    figs = [plt.figure(n) for n in plt.get_fignums()]
    windows = len(figs) - 1
    assert windows >= 2 and all(f.axes[0].get_title() == f"Audio signal\n{wav}"
                                for f in figs[:-1])
    assert figs[-1].axes[0].get_title() == f"Probs {wav}"
    stitched = np.asarray(figs[-1].axes[0].collections[0].get_array())
    # The same MIDI as the batch path.
    first = (tmp_path / "out.mid").read_bytes()
    assert pt_cli.main(argv) == 0
    assert (tmp_path / "out.mid").read_bytes() == first
    assert out.splitlines()[0] == capsys.readouterr().out.splitlines()[0]
    assert stitched.size == int(out.split("(")[1].split(",")[0]) * 90


def test_dataset_harness_writes_its_figures(tmp_path, monkeypatch, capsys):
    # One sample longer than the default 5 s window, so that a window lives.
    synthetic.make_synthetic_dataset(tmp_path / "data", num_samples=1, duration_s=6.0, seed=6)
    monkeypatch.chdir(tmp_path)
    assert data_main.main([str(tmp_path / "data"), "--batches", "1", "--batch-size", "1",
                           "--no-transforms", "--visualize"]) == 0
    assert "wrote sample_batch0.png" in capsys.readouterr().out
    assert (tmp_path / "sample_batch0.png").stat().st_size > 0
