"""The port's population over ranks against the JAX package's step and its
own in-process population: a population of 2 on an ensemble axis of 2 and
DP 2 x TP 2 against JAX's step on the same mesh shapes of virtual CPU
devices (tolerances as tests/test_torch_parallel_vs_jax.py's), and a
population of 4 on an ensemble axis of 4, one member per rank, against the
port's in-process population (tests/test_torch_ensemble.py's), bit for bit:
each member's loss with dropout, the evaluation's scores, the evolution's
children and the checkpoint's (4,)-leading leaves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from audio_to_midi_tpu_torch.data import synthetic
from audio_to_midi_tpu_torch.train import checkpoint as ckpt
from tests.test_torch_parallel import batch, jobs, run_ranks, tiny_cfg
from tests.test_torch_parallel_vs_jax import check_step, population

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """A group of 2 ranks (E = 2 on the ensemble axis) and one of 4 (DP 2 x
    TP 2, and E = 4 on the ensemble axis)."""
    tmp = tmp_path_factory.mktemp("ensemble_vs_jax")
    cfg = tiny_cfg()
    audio, labels = batch(1, cfg)
    flat = {k: v[0] for k, v in population(cfg, 1).items()}
    two = run_ranks(tmp, 2, jobs, {"steps": ("steps_job", {"steps": [
        ("ens2", (cfg, population(cfg, 2), (2, 1, 1), audio, labels), {})]})})
    synthetic.make_synthetic_dataset(tmp / "test", num_samples=1, duration_s=0.5,
                                     notes_per_sample=2, seed=3)
    ens_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, transformer_dropout_rate=0.1),
        train=dataclasses.replace(cfg.train, ensemble_size=4))
    four = run_ranks(tmp, 4, jobs, {
        "steps": ("steps_job", {"steps": [("dp2_tp2", (cfg, flat, (1, 2, 2), audio, labels),
                                           {})]}),
        "ensemble": ("ensemble_axis_job", {"cfg": ens_cfg, "flat": population(cfg, 4),
                                           "audio": audio, "labels": labels,
                                           "testset": str(tmp / "test")})})
    return {"cfg": cfg, "audio": audio, "labels": labels, "two": two, "four": four}


def test_population_on_an_ensemble_axis_of_two_matches_jax(groups):
    cfg = groups["cfg"]
    check_step([r["steps"]["ens2"] for r in groups["two"]], cfg, (2, 1, 1), population(cfg, 2),
               groups["audio"], groups["labels"])


def test_dp_and_tp_together_match_jax(groups):
    cfg = groups["cfg"]
    check_step([r["steps"]["dp2_tp2"] for r in groups["four"]], cfg, (1, 2, 2),
               population(cfg, 1), groups["audio"], groups["labels"])


def test_ensemble_axis_matches_the_in_process_population(groups):
    """E = 4, one member per rank: each member's loss is the in-process
    population's bit for bit (the same weights and member seeds, dropout
    0.1), the scores gathered over the axis are its scores, the evolution
    gives its children, and the checkpoint holds (4,)-leading leaves."""
    ranks = [r["ensemble"] for r in groups["four"]]
    ref = ranks[0]["ref"]
    assert np.all(np.isfinite(ref["loss"])) and ref["loss"].shape == (4,)
    for got in ranks:
        np.testing.assert_array_equal(got["loss"], ref["loss"])
        np.testing.assert_array_equal(got["valid"], ref["valid"])
        np.testing.assert_array_equal(got["scores"], ref["scores"])
        assert got["regenerated"] == [int(i) for i in np.argsort(ref["scores"])[2:]]
        assert got["evolved"].keys() == ref["evolved"].keys()
        for k, v in ref["evolved"].items():
            np.testing.assert_array_equal(got["evolved"][k], v, err_msg=k)
    flat, step = ckpt.restore_raw(ranks[0]["ck"])
    assert step == 7 and all(v.shape[0] == 4 for v in flat.values())
    for k, v in ranks[0]["evolved"].items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
