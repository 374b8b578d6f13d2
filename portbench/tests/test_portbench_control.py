"""What ``correct`` catches, at sizes a CPU test run holds.

The control (the reference in the precision below the configuration's:
the model's products in float8 e4m3 with e5m2 gradients, the audio's in
TF32) put in the program's place comes out not correct; and a run with
the timed path broken underneath comes out not correct, once for each
fault a cell can have: an answer altered where it is produced (serving
and training), a step that returns its state unchanged, a step that
averages over half of its batch.  One cell runs on one card, so no
exchange between cards exists to leave out.  On the card the same
readings come from ``calibrate.py`` at each cell's own size.
"""

import numpy as np
import pytest
import torch

import pb_cells
from portbench.reference import nets, sample

FP8 = nets.Precision("fp8")


def test_sound_runs_are_correct():
    assert pb_cells.run(pb_cells.serve_cell())["correct"]
    assert pb_cells.run(pb_cells.train_cell())["correct"]


def test_serving_control_is_not_correct(monkeypatch):
    from music_style_transfer_ldm_tpu_torch.serving import engine as mod
    cell = pb_cells.serve_cell()

    def control(ldm, content, style, num_timesteps=50, eta=0.0,
                sampler="ddim", steps=None, seeds=0, **_):
        P = {k: v.float() for k, v in ldm.state_dict().items()}
        out = sample.transfer(P, content[..., 0], style[..., 0],
                              np.atleast_1d(seeds).tolist(),
                              cell.config["model"], num_timesteps, FP8)
        return out[..., None]
    monkeypatch.setattr(mod, "fused_content_style_transfer", control)
    result = pb_cells.run(cell)
    assert not result["correct"]
    assert result["checks"]["image_gap"]["value"] > \
        result["checks"]["image_gap"]["limit"]


def test_training_control_is_not_correct():
    cell = pb_cells.train_cell()
    from portbench.drivers import train_ldm
    run = train_ldm.run(cell, 2 ** 34 + 1, 1.0, False, "cpu", 0.0)
    readings = train_ldm.control(cell, run["sample"], 2 ** 34 + 1)
    limits = cell.config["limits"]["train_ldm"]
    assert any(readings["control"][k] > v for k, v in limits.items())
    assert any(readings["half_batch"][k] > v for k, v in limits.items())


def test_serving_answer_altered_is_not_correct(monkeypatch):
    from music_style_transfer_ldm_tpu_torch.serving import engine as mod
    original = mod.InferenceEngine._finish_outputs

    def altered(self, decoded):
        decoded = decoded.clone()
        decoded[0] = torch.clamp(decoded[0] + 0.1, 0.0, 1.0)
        return original(self, decoded)
    monkeypatch.setattr(mod.InferenceEngine, "_finish_outputs", altered)
    assert not pb_cells.run(pb_cells.serve_cell())["correct"]


@pytest.fixture
def trainer_class():
    from music_style_transfer_ldm_tpu_torch.training.train_ldm import (
        LDMTrainer,
    )
    return LDMTrainer


def test_step_that_returns_its_state_unchanged(monkeypatch, trainer_class):
    original = trainer_class._step

    def unchanged(self, state, content, style, *a, **k):
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        state, metrics = original(self, state, content, style, *a, **k)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(before[n])
        return state, metrics
    monkeypatch.setattr(trainer_class, "_step", unchanged)
    result = pb_cells.run(pb_cells.train_cell())
    assert not result["correct"]
    assert result["checks"]["change_gap_median"]["value"] > 0.5


def test_step_over_half_the_batch(monkeypatch, trainer_class):
    original = trainer_class._step

    def halved(self, state, content, style, *a, **k):
        half = content.shape[0] // 2
        return original(self, state, content[:half], style[:half], *a, **k)
    monkeypatch.setattr(trainer_class, "_step", halved)
    assert not pb_cells.run(pb_cells.train_cell())["correct"]


def test_training_answer_altered_is_not_correct(monkeypatch):
    from music_style_transfer_ldm_tpu_torch.training import train_ldm
    original = train_ldm.style_loss

    def altered(*a, **k):
        return original(*a, **k) * 1.01
    monkeypatch.setattr(train_ldm, "style_loss", altered)
    result = pb_cells.run(pb_cells.train_cell())
    assert not result["correct"]
    assert result["checks"]["style_term_gap"]["value"] > \
        result["checks"]["style_term_gap"]["limit"]


@pytest.mark.card
def test_cells_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    from portbench import core
    for name in ("serve-fused-closed", "train-ldm-b128"):
        cell = core.load_cell(name)
        result = core.run_cell(cell, 2 ** 33 + 9, 3.0, False, "cuda",
                               time.perf_counter())
        assert result["correct"], result["checks"]
