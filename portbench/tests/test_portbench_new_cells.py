"""The two cells added with Riffusion v1, cut to CPU size as
``pb_cells.py`` cuts the others: ``serve-riffusion-closed`` (a tiny
Riffusion at the configuration's structure) and ``train-ae-b128`` (B=8,
64x64).  A sound run of each driver is correct, its control is over the
limits, planted faults in the prompts' path show in the check, the
Riffusion run records the program's new spans and counters and the
harness's, the new readers read them, and a program without the
Riffusion model stops at once."""

import sys
import time

import numpy as np
import pytest
import torch

from portbench import core, riffusion_cost, state
from portbench.drivers import serve_riffusion, train_ae
from portbench.reference import riffusion as ref

SEED = 2 ** 33 + 7


def riffusion_cell():
    cell = core.load_cell("serve-riffusion-closed")
    m = cell.config["model"]
    m["image_size"] = 32
    m["text"].update(vocab_size=64, width=32, layers=2, heads=4, mlp_dim=64,
                     bos_id=62, eos_id=63)
    m["unet"].update(block_out_channels=[32, 64],
                     cross_attention=[True, False], layers_per_block=1,
                     heads=4, cross_attention_dim=32, groups=8,
                     time_proj_dim=32, time_embed_dim=64)
    m["vae"].update(block_out_channels=[16, 32], layers_per_block=1,
                    groups=8)
    cell.config["serve"]["audio"].update(
        sample_rate=8000, n_fft=256, win_length=128, hop_length=64,
        n_mels=32, fmax=3000.0, clip_seconds=32 * 64 / 8000)
    cell.config["serve"]["sample_steps"] = 6
    cell.traffic.update(clients=2, buckets=[1, 2], preroll_s=0.3,
                        trace_s=0.5, trace_offset=0.1)
    cell.traffic["check"] = {"share": 1.0, "max": 4}
    return cell


def ae_cell():
    cell = core.load_cell("train-ae-b128")
    cell.config["model"]["image_size"] = 64
    cell.traffic.update(batch_size=8, trace_s=0.5, trace_offset=0.1,
                        corpus={"images": 40, "classes": 4, "pairs": 100})
    return cell


@pytest.fixture(scope="module")
def riffusion_run():
    return serve_riffusion.run(riffusion_cell(), SEED, 1.5, True, "cpu",
                               time.perf_counter())


def test_riffusion_sound_run_is_correct(riffusion_run):
    run = riffusion_run
    assert run["failed"] == 0 and run["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in run["checks"].values()), \
        run["checks"]
    stats = run["ctx"]["stats"]
    assert stats["guided_rows"] > 0 and stats["prompts_encoded"] > 0
    assert stats["audio_eager_runs"] > 0


def test_riffusion_run_records_the_programs_spans(riffusion_run):
    p = riffusion_run["ctx"]["program"]
    names = {r.name for r in p["spans"]}
    assert {"riffusion.text", "ldm.encode", "ldm.sample", "ldm.decode",
            "audio.nnls", "audio.griffin_lim", "engine.batch"} <= names
    assert p["counters"]["unet.calls"] % 5 == 0
    assert p["counters"]["unet.rows"] >= 2 * p["counters"]["unet.calls"]
    # on the CPU no span carries a device interval: the readers find none
    for name in ("riffusion.text_device_ms", "riffusion.vae_device_ms",
                 "ldm.sample_device_ms.riffusion"):
        assert core.reader(name)(riffusion_run["ctx"]) is None


def test_riffusion_harness_spans_are_read(riffusion_run):
    ctx = riffusion_run["ctx"]
    for name in ("engine.batch_ms.riffusion", "serve.latency_p95_ms.riffusion",
                 "ldm.transfer_ms_per_batch.riffusion",
                 "audio.invert_ms_per_batch.riffusion"):
        assert core.reader(name)(ctx) > 0, name
    # no device trace on the CPU
    assert core.reader("ddim_update_roofline.riffusion")(ctx) is None


def _permuted_prompts(monkeypatch):
    """Each dispatch's prompt rows rolled by one: a slot reads its
    neighbour's prompt."""
    from music_style_transfer_ldm_tpu_torch.models import riffusion
    condition = riffusion.Riffusion.condition
    monkeypatch.setattr(riffusion.Riffusion, "condition",
                        lambda self, p: condition(self, p).roll(1, 0))


def _swapped_branches(monkeypatch):
    """The guided batch's conditional and unconditional halves swapped."""
    from music_style_transfer_ldm_tpu_torch.models import ldm
    denoise = ldm._denoise_fn

    def swapped(model, emb, guidance=1.0, f32=True, uncond=None):
        if uncond is None:
            return denoise(model, emb, guidance, f32)
        return denoise(model, uncond, guidance, f32, uncond=emb)
    monkeypatch.setattr(ldm, "_denoise_fn", swapped)


def test_swapped_guidance_branches_are_not_correct(monkeypatch):
    _swapped_branches(monkeypatch)
    run = serve_riffusion.run(riffusion_cell(), SEED, 1.5, False, "cpu",
                              time.perf_counter())
    gap = run["checks"]["image_gap"]
    assert gap["value"] > gap["limit"], gap


def _two_prompt_image_gap() -> float:
    """The check's image gap of one dispatch of two clips under two
    different prompts, served by the cell's engine."""
    cell, dev = riffusion_cell(), torch.device("cpu")
    cfg, mix = cell.config, cell.traffic
    weights = ref.seeded_weights(cfg["model"], SEED, dev)
    engine = serve_riffusion.build_engine(cell, weights, dev)
    rng = np.random.default_rng([SEED, 0])
    content = state.image_pool(2, cfg["model"]["image_size"], rng)
    prompts = serve_riffusion.prompt_pool(mix, cfg["model"]["text"], rng, 2)
    out = engine.transfer_batch(content, prompts, seeds=[5, 6])
    return serve_riffusion.gaps(
        serve_riffusion.reference_weights(weights, cfg), cfg, content,
        prompts, [(0, 0, 5), (1, 1, 6)], out["image"][..., 0],
        out["audio"], dev)["image_gap"]


def test_permuted_prompts_are_not_correct(monkeypatch):
    lim = riffusion_cell().config["limits"]["serve_riffusion"]["image_gap"]
    assert _two_prompt_image_gap() <= lim
    _permuted_prompts(monkeypatch)
    assert _two_prompt_image_gap() > lim


def test_riffusion_control_is_over_its_limits(riffusion_run):
    cell = riffusion_cell()
    readings = serve_riffusion.control(cell, riffusion_run["sample"], SEED,
                                       torch.device("cpu"))["control"]
    lim = cell.config["limits"]["serve_riffusion"]
    assert readings["image_gap"] > lim["image_gap"]


def test_ae_sound_run_is_correct():
    result = core.run_cell(ae_cell(), SEED, 1.0, True, "cpu",
                           time.perf_counter())
    assert result["correct"], result["checks"]
    assert "data.batch_ms.ldm" in result["metrics"]


def test_ae_control_and_half_batch_are_over_the_limits():
    cell = ae_cell()
    run = train_ae.run(cell, 2 ** 34 + 1, 0.5, False, "cpu", 0.0)
    readings = train_ae.control(cell, run["sample"], 2 ** 34 + 1)
    limits = cell.traffic["limits"]
    for kind in ("control", "half_batch"):
        for k in ("grad_gap", "grad_diff_median"):
            assert readings[kind][k] > limits[k], (kind, k, readings[kind])


def test_ae_step_that_returns_its_state_unchanged(monkeypatch):
    from music_style_transfer_ldm_tpu_torch.training.train_autoencoder import (
        AETrainer,
    )
    original = AETrainer._step

    def unchanged(self, state, x, *a, **k):
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        state, loss = original(self, state, x, *a, **k)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(before[n])
        return state, loss
    monkeypatch.setattr(AETrainer, "_step", unchanged)
    run = train_ae.run(ae_cell(), SEED, 0.3, False, "cpu", 0.0)
    assert run["readings"]["change_gap_median"] > 0.5


def test_a_program_without_riffusion_stops_at_once(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "music_style_transfer_ldm_tpu_torch.models.riffusion",
                        None)
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        serve_riffusion.run(riffusion_cell(), SEED, 1.0, False, "cpu", t0)
    assert time.perf_counter() - t0 < 5.0


def rec(name, start, end, device_ms=None):
    from music_style_transfer_ldm_tpu_torch.utils import profiling
    return profiling.SpanRecord(name, start, end, 0, None, None, {},
                                device_ms)


def test_new_readers_on_a_synthetic_context():
    ctx = {"device_kind": "NVIDIA H100 80GB HBM3",
           "program": {"spans": [rec("riffusion.text", 11, 11.1, 1.0),
                                 rec("riffusion.text", 12, 12.1, 3.0),
                                 rec("ldm.encode", 11, 11.1, 20.0),
                                 rec("ldm.decode", 11, 11.1, 90.0),
                                 rec("ldm.decode", 15, 15.1, 1e3)],
                       "counters": {}, "pending": 0,
                       "window": (10.0, 20.0), "exclude": (14.0, 16.0)}}
    assert core.reader("riffusion.text_device_ms")(ctx) == 2.0
    assert core.reader("riffusion.vae_device_ms")(ctx) == 110.0
    assert core.reader("riffusion.vae_device_ms")({}) is None


def test_ddim_update_roofline_reader_on_riffusion():
    cell = core.load_cell("serve-riffusion-closed")
    # 37 launches at a mean of 3.5 rows of [4, 64, 64], f32 latent and
    # guided eps, that ran at exactly half the HBM rate
    secs = 37 * 3.5 * 4 * 64 * 64 * 12 / (0.5 * 3.35e12)
    ctx = {"cell": cell, "device_kind": "NVIDIA H100 80GB HBM3",
           "stats": {"batches": 2, "rows_dispatched": 6, "padded_slots": 1},
           "trace": {"kernels": {"ddim_update_kernel": [37, secs]}}}
    got = core.reader("ddim_update_roofline.riffusion")(ctx)
    assert abs(got - 50.0) < 1e-9
    assert core.reader("ddim_update_roofline.riffusion")(
        dict(ctx, trace=None)) is None


def test_attention_roofline_reader():
    cell = core.load_cell("serve-riffusion-closed")
    model = cell.config["model"]
    shapes = riffusion_cost.transformer_shapes(model)
    assert len(shapes) == 16
    assert shapes.count((4096, 320)) == 5 and shapes.count((64, 1280)) == 1
    per_row = riffusion_cost.attention_flops_per_row(model)
    want = sum(4 * n * n * c + 4 * n * 77 * c for n, c in shapes)
    assert per_row == want
    # 37 calls at 8 rows whose attention ran at exactly 40 % of the peak
    secs = 37 * 8 * per_row / (0.4 * 989e12)
    ctx = {"cell": cell, "device_kind": "NVIDIA H100 80GB HBM3",
           "stats": {"batches": 1, "rows_dispatched": 3, "padded_slots": 1},
           "trace": {"kernels": {
               "ddim_update_kernel": [37, 0.001],
               "cudnn_generated_fort_native_sdpa_sm90_flash_fprop": [592,
                                                                    secs],
               "fmha_cutlassF_bf16_aligned_64x128": [2, 5.0]}}}
    assert abs(core.reader("attention_roofline.riffusion")(ctx) - 40.0) < 1e-9
    assert core.reader("attention_roofline.riffusion")(
        dict(ctx, trace=None)) is None
