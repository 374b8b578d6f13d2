"""The plain reference against the port on the CPU, at small sizes: the
model's pieces, the served transfer, the audio inversion, the loss terms
and whole training steps, all float32 (the port runs its kernels' plain
versions on CPU tensors)."""

import dataclasses

import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu_torch.audio.griffinlim import mel_to_audio
from music_style_transfer_ldm_tpu_torch.losses.lpips import LPIPS
from music_style_transfer_ldm_tpu_torch.losses.vggish import (
    VGGishFeatures, vggish_feature_distance,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import transfer_decoded
from portbench import compare, core, state
from portbench.reference import audio, nets, sample, weights
from portbench.reference import train as ref_train

MODEL = {"image_size": 128, "latent_dim": 8, "unet_num_filters": 64,
         "style_num_filters": 64, "time_emb_dim": 128, "attn_num_heads": 4,
         "num_timesteps": 200, "beta_start": 1e-4, "beta_end": 0.02}
SEED = 2 ** 32 + 11


@pytest.fixture(scope="module")
def params():
    return weights.seeded_weights(MODEL, SEED, "cpu", trunks=True)


@pytest.fixture(scope="module")
def ldm(params):
    return state.make_ldm(MODEL, params["ldm"], torch.float32, "cpu")


def images(n, size=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, size, size, generator=g)


def close(a, b, tol):
    a, b = a.float(), b.float()
    scale = max(float(b.abs().max()), 1e-12)
    assert float((a - b).abs().max()) <= tol * scale


def test_encoder_decoder_and_style_pyramid(params, ldm):
    P, x = params["ldm"], images(2)
    close(nets.encoder(P, x[:, None]), ldm.encoder(x[:, None]), 1e-5)
    z = torch.randn(2, MODEL["latent_dim"], 16, 16)
    close(nets.decoder(P, z), ldm.decoder(z), 1e-5)
    s5, s6 = nets.style_pyramid(P, x[:, None])
    emb = ldm.style_encoder(x[:, None])
    close(s5, emb["s5"], 1e-5)
    close(s6, emb["s6"], 1e-5)


def test_unet(params, ldm):
    P, x = params["ldm"], images(2)
    s5, s6 = nets.style_pyramid(P, x[:, None])
    z = torch.randn(2, MODEL["latent_dim"], 16, 16)
    t = torch.tensor([3, 150])
    close(nets.unet(P, z, t, s5, s6), ldm.unet(z, t, {"s5": s5, "s6": s6}),
          1e-5)


def test_train_mode_batch_norm_statistics(params, ldm):
    P = params["ldm"]
    z = torch.randn(3, MODEL["latent_dim"], 16, 16)
    stats = {}
    out = nets.decoder(P, z, True, stats)
    model = state.make_ldm(MODEL, P, torch.float32, "cpu")
    close(out, model.decoder(z, train=True), 1e-5)
    close(stats["decoder.bn1.running_var"],
          model.decoder.bn1.running_var, 1e-6)


def test_served_transfer_matches_the_scan_route(params, ldm):
    c, s = images(3, seed=1), images(3, seed=2)
    seeds = [5, 2 ** 31 - 2, 77]
    ref = sample.transfer(params["ldm"], c, s, seeds, MODEL, steps=6)
    got, _ = transfer_decoded(ldm, c[..., None], s[..., None],
                              num_timesteps=6, seeds=np.asarray(seeds))
    close(ref, got[..., 0], 1e-4)


def test_audio_inversion_matches_the_engine(params):
    img = images(2, seed=3)
    a = {"sample_rate": 22050, "n_fft": 2048, "hop_length": 512,
         "nnls_iters": 8, "griffin_lim_iters": 4, "seconds": 3.0}
    ref = audio.image_to_audio(img, a)
    db = img * 80.0 - 80.0
    got = mel_to_audio(torch.pow(10.0, 0.1 * db), sr=22050, n_fft=2048,
                       hop_length=512, n_iter=4, nnls_iters=8,
                       length=66150)
    close(ref, got, 1e-5)


def test_feature_distances(params):
    a, b = images(2, 64, seed=4), images(2, 64, seed=5)
    vgg = VGGishFeatures()
    vgg.load_state_dict(params["vggish"])
    got = vggish_feature_distance(vgg, a[..., None], b[..., None],
                                  impl="plain")
    close(ref_train.vggish_distance(params["vggish"], a, b), got, 1e-5)
    lp = LPIPS()
    lp.load_state_dict(params["lpips"])
    close(ref_train.lpips(params["lpips"], a, b),
          lp(a[..., None], b[..., None]), 1e-5)


def test_training_steps_match_the_trainer(params):
    from music_style_transfer_ldm_tpu_torch.training.train_ldm import (
        LDMTrainer,
    )
    from portbench.drivers.train_ldm import (
        first_grads, snapshot, trainer_config,
    )
    cell = core.load_cell("train-ldm-b128")
    cell.config["model"] = dict(MODEL, image_size=64)
    cell.traffic = dict(cell.traffic, batch_size=4)
    trainer = LDMTrainer(trainer_config(cell, SEED), device="cpu",
                         compression_feature_params=params["lpips"],
                         style_feature_params=params["vggish"])
    st = trainer.init_state(seed=0)
    st.model.load_state_dict(params["ldm"])
    names = [k for k, p in st.model.named_parameters() if p.requires_grad]
    theta0 = snapshot(st, names)
    batches = [(images(4, 64, seed=10 + i), images(4, 64, seed=20 + i))
               for i in range(2)]
    losses = []
    for i, (c, s) in enumerate(batches):
        st, m = trainer._step(st, c[..., None], s[..., None])
        losses.append(float(m["total_loss"]))
        if i == 0:
            grads = first_grads(st, names)
    tcfg = dict(cell.config["train"]["ldm"], batch_size=4)
    ref = ref_train.ldm_steps(params["ldm"], {"vggish": params["vggish"],
                                               "lpips": params["lpips"]},
                              batches, SEED, cell.config["model"], tcfg)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    top = max(float(g.abs().max()) for g in ref["first_grads"].values())
    for k in names:
        diff = float((grads[k] - ref["first_grads"][k]).abs().max())
        assert diff <= 1e-4 * top, k
    gaps = compare.train_gaps(
        {"losses": losses, "first_grads": grads,
         "params": snapshot(st, names)}, ref, theta0)
    assert gaps["change_gap_median"] < 1e-4


def test_fp8_control_differs_and_its_gradient_is_rounded():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    q = nets.Precision("fp8").q(x)
    assert 0 < float((q - x).detach().abs().max()) < 0.2
    (q * torch.linspace(0, 1, 101)).sum().backward()
    g = x.grad
    assert float((g - torch.linspace(0, 1, 101)).abs().max()) > 0
    assert nets.Precision("float32").q(x) is x


def test_weights_are_seeded_and_named_as_the_port(params, ldm):
    again = weights.seeded_weights(MODEL, SEED, "cpu")["ldm"]
    assert all(torch.equal(again[k], params["ldm"][k]) for k in again)
    other = weights.seeded_weights(MODEL, SEED + 1, "cpu")["ldm"]
    assert not torch.equal(other["unet.enc1.weight"],
                           params["ldm"]["unet.enc1.weight"])
    assert set(ldm.state_dict()) == set(params["ldm"])
    assert dataclasses.is_dataclass(core.Cell)
