"""The port's import of the reference's own PyTorch weights
(``interop/torch_weights.py``, ``cli import-torch``) against the JAX
package's converters.

The reference's state dicts are built here in its key layout with random
values (no real weights are in the repository): the encoder and decoder
as the reference's ``nn.Sequential``s, the UNet's attention as
``nn.MultiheadAttention``.  Each goes through the JAX package's
``convert_*`` and the port's ``load_flax_variables`` into one port model,
and through the port's direct ``convert_*`` into another.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from music_style_transfer_ldm_tpu.interop import (
    convert_ldm_state_dict as jax_convert_ldm,
)
from music_style_transfer_ldm_tpu.losses.lpips import (
    convert_torch_lpips_state_dict as jax_convert_lpips,
)
from music_style_transfer_ldm_tpu.losses.vggish import (
    convert_torchvggish_state_dict as jax_convert_vggish,
)
from music_style_transfer_ldm_tpu.models.ldm import LDM as JaxLDM
from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch.interop import (
    convert_autoencoder_state_dicts, convert_decoder_state_dict,
    convert_encoder_state_dict, convert_ldm_state_dict,
    convert_style_encoder_state_dict, convert_unet_state_dict,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_convs, load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.losses.feature import (
    build_feature_metric,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm, load_ldm
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt
from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray

ATOL = 1e-5   # model outputs, f32 both sides (tests/test_torch_models.py)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------- the reference's layouts, random values ----------------------


def _randomise_bn(module, rng):
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.tensor(1.0 + 0.1 * rng.randn(n)))
                m.bias.copy_(torch.tensor(0.1 * rng.randn(n)))
                m.running_mean.copy_(torch.tensor(0.1 * rng.randn(n)))
                m.running_var.copy_(torch.tensor(0.5 + rng.rand(n)))
                m.num_batches_tracked.fill_(1234)


def reference_encoder(rng):
    """The reference's ``SpectrogramEncoder.encoder`` Sequential."""
    enc = nn.Sequential(
        nn.Conv2d(1, 64, 3, 2, 1), nn.BatchNorm2d(64), nn.ReLU(),
        nn.Conv2d(64, 128, 3, 2, 1), nn.BatchNorm2d(128), nn.ReLU(),
        nn.Conv2d(128, 32, 3, 2, 1), nn.BatchNorm2d(32))
    _randomise_bn(enc, rng)
    return enc.eval()


def reference_decoder(rng):
    """The reference's ``SpectrogramDecoder.decoder`` Sequential."""
    dec = nn.Sequential(
        nn.ConvTranspose2d(32, 128, 4, 2, 1), nn.BatchNorm2d(128), nn.ReLU(),
        nn.ConvTranspose2d(128, 64, 4, 2, 1), nn.BatchNorm2d(64), nn.ReLU(),
        nn.ConvTranspose2d(64, 1, 4, 2, 1), nn.Tanh())
    _randomise_bn(dec, rng)
    return dec.eval()


def reference_unet_state_dict():
    """The reference UNet's keys and shapes: time_mlp Linears at indices 1
    and 3, enc1..enc4, the two attentions' nn.MultiheadAttention,
    bottleneck, dec4..dec2 (ConvTranspose2d k3 s2 p1 op1), dec1."""
    m = nn.Module()
    m.time_mlp = nn.Sequential(nn.Identity(), nn.Linear(128, 128), nn.GELU(),
                               nn.Linear(128, 128))
    for i, (ci, co) in enumerate(((32, 64), (64, 128), (128, 256),
                                  (256, 512)), 1):
        setattr(m, f"enc{i}", nn.Conv2d(ci, co, 3, 1 if i == 1 else 2, 1))
    for name, e in (("cross_attention1", 512), ("cross_attention2", 256)):
        block = nn.Module()
        block.multihead_attn = nn.MultiheadAttention(e, 4)
        with torch.no_grad():   # its default in_proj_bias is all zero
            block.multihead_attn.in_proj_bias.normal_(0.0, 0.1)
        setattr(m, name, block)
    m.bottleneck = nn.Conv2d(512, 512, 3, 1, 1)
    for i, (ci, co) in ((4, (512, 256)), (3, (256, 128)), (2, (128, 64))):
        setattr(m, f"dec{i}", nn.ConvTranspose2d(ci, co, 3, 2, 1, 1))
    m.dec1 = nn.Conv2d(64, 32, 3, 1, 1)
    return m.state_dict()


def reference_style_encoder_state_dict():
    chans = ((1, 64), (64, 128), (128, 256), (256, 256), (256, 256),
             (256, 512))
    return {f"enc{i}.{k}": v
            for i, (ci, co) in enumerate(chans, 1)
            for k, v in nn.Conv2d(ci, co, 3, 2, 1).state_dict().items()}


@functools.lru_cache(maxsize=1)
def reference():
    """(encoder, decoder, the full ``ldm_<epoch>.pth`` state dict)."""
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    enc, dec = reference_encoder(rng), reference_decoder(rng)
    flat = {}
    for prefix, sd in (("encoder.encoder.", enc.state_dict()),
                       ("decoder.decoder.", dec.state_dict()),
                       ("unet.", reference_unet_state_dict()),
                       ("style_encoder.",
                        reference_style_encoder_state_dict())):
        flat.update({prefix + k: v for k, v in sd.items()})
    flat["noise_scheduler.betas"] = torch.linspace(1e-4, 0.02, 200)
    return enc, dec, flat


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@functools.lru_cache(maxsize=1)
def both_routes():
    """(port model through the JAX converter, port model through the
    direct map, the JAX payload)."""
    _, _, flat = reference()
    payload = jax_convert_ldm(_numpy(flat))
    via_jax = build_ldm(device="cpu", seed=5)
    load_flax_variables(via_jax, payload)
    direct = build_ldm(device="cpu", seed=6)
    direct.load_state_dict(convert_ldm_state_dict(flat))
    return via_jax, direct, payload


# ---------------- converters ---------------------------------------------------

COMPONENTS = ("encoder", "decoder", "unet", "style_encoder")


@pytest.mark.parametrize("comp", COMPONENTS)
def test_direct_import_equals_the_jax_converters(comp):
    """The two routes give the same state dict, bit for bit; the
    component converter alone gives the LDM converter's slice."""
    via_jax, direct, _ = both_routes()
    a = getattr(via_jax, comp).state_dict()
    b = getattr(direct, comp).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), (comp, k)
    _, _, flat = reference()
    single = {"encoder": convert_encoder_state_dict,
              "decoder": convert_decoder_state_dict,
              "unet": convert_unet_state_dict,
              "style_encoder": convert_style_encoder_state_dict}[comp]
    sub = {k[len(comp) + 1:]: v for k, v in flat.items()
           if k.startswith(comp + ".")}
    got = single(sub)
    assert got.keys() == b.keys()
    for k in got:
        assert torch.equal(got[k], b[k]), (comp, k)


def test_autoencoder_pair_and_the_reference_modules():
    """encoder.pth + decoder.pth (keys with the attribute prefix): the
    converted modules reproduce the reference's Sequentials, transpose
    convs included, and the BatchNorm count is reset."""
    enc, dec, _ = reference()
    _, direct, _ = both_routes()
    params = convert_autoencoder_state_dicts(
        {f"encoder.{k}": v for k, v in enc.state_dict().items()},
        {f"decoder.{k}": v for k, v in dec.state_dict().items()})
    for comp in ("encoder", "decoder"):
        want = getattr(direct, comp).state_dict()
        assert params[comp].keys() == want.keys()
        for k, v in params[comp].items():
            assert torch.equal(v, want[k]), (comp, k)
    assert int(params["encoder"]["bn1.num_batches_tracked"]) == 0
    x = torch.rand(2, 128, 128, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        z_ref = enc(x.permute(0, 3, 1, 2))
        np.testing.assert_allclose(direct.encode(x).numpy(),
                                   z_ref.permute(0, 2, 3, 1).numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(
            direct.decode(z_ref.permute(0, 2, 3, 1)).numpy(),
            dec(z_ref).permute(0, 2, 3, 1).numpy(), atol=ATOL)


OUTPUTS = ("encode", "decode", "style_embed", "denoise")


@pytest.mark.parametrize("method", OUTPUTS)
def test_imported_model_matches_the_jax_model(method):
    """The directly imported port model against the JAX LDM on the JAX
    converter's variables: a flipped or misplaced transpose-conv kernel
    would show here."""
    _, direct, payload = both_routes()
    rng = np.random.RandomState(OUTPUTS.index(method))
    model = JaxLDM(dtype=jnp.float32)
    variables = jax.tree_util.tree_map(jnp.asarray, payload)
    img = rng.rand(2, 128, 128, 1).astype(np.float32)
    z = rng.randn(2, 16, 16, 32).astype(np.float32)
    with torch.no_grad():
        if method == "encode":
            got = direct.encode(torch.tensor(img))
            want = model.apply(variables, img, method=JaxLDM.encode)
        elif method == "decode":
            got = direct.decode(torch.tensor(z))
            want = model.apply(variables, z, method=JaxLDM.decode)
        elif method == "style_embed":
            got = direct.style_embed(torch.tensor(img))["s6"]
            want = model.apply(variables, img,
                               method=JaxLDM.style_embed)["s6"]
        else:
            t = np.asarray([3, 150], np.int32)
            emb = model.apply(variables, img, method=JaxLDM.style_embed)
            want = model.apply(variables, z, t, emb, method=JaxLDM.denoise)
            got = direct.denoise(torch.tensor(z), torch.tensor(t),
                                 {k: torch.tensor(np.asarray(v))
                                  for k, v in emb.items()})
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---------------- feature weights -----------------------------------------------


def fake_torchvggish_state_dict(rng):
    """torchvggish ``features`` keys and shapes (convs at 0, 3, 6, 8, 11,
    13), random values."""
    sd = {}
    for cin, cout, idx in ((1, 64, 0), (64, 128, 3), (128, 256, 6),
                           (256, 256, 8), (256, 512, 11), (512, 512, 13)):
        sd[f"features.{idx}.weight"] = torch.tensor(
            0.05 * rng.randn(cout, cin, 3, 3), dtype=torch.float32)
        sd[f"features.{idx}.bias"] = torch.tensor(
            0.05 * rng.randn(cout), dtype=torch.float32)
    return sd


def fake_lpips_state_dict(rng):
    """``lpips.LPIPS(net='alex')`` keys and shapes, random values."""
    sd = {}
    for key, cin, cout, k in (("net.slice1.0", 3, 64, 11),
                              ("net.slice2.3", 64, 192, 5),
                              ("net.slice3.6", 192, 384, 3),
                              ("net.slice4.8", 384, 256, 3),
                              ("net.slice5.10", 256, 256, 3)):
        sd[f"{key}.weight"] = torch.tensor(0.05 * rng.randn(cout, cin, k, k),
                                           dtype=torch.float32)
        sd[f"{key}.bias"] = torch.tensor(0.05 * rng.randn(cout),
                                         dtype=torch.float32)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        sd[f"lin{i}.model.1.weight"] = torch.tensor(
            np.abs(rng.randn(1, c, 1, 1)), dtype=torch.float32)
    return sd


# ---------------- CLI -----------------------------------------------------------

KINDS = ("ldm", "autoencoder", "vggish", "lpips")


def _import(kind, tmp_path):
    """cli import-torch of one input kind; returns (out path, the state
    dict(s) written by the reference)."""
    enc, dec, flat = reference()
    rng = np.random.RandomState(4)
    out = tmp_path / f"{kind}.pt"
    if kind == "ldm":
        torch.save(flat, tmp_path / "ldm_7.pth")
        args, src = ["--ldm", str(tmp_path / "ldm_7.pth")], flat
    elif kind == "autoencoder":
        src = ({f"encoder.{k}": v for k, v in enc.state_dict().items()},
               {f"decoder.{k}": v for k, v in dec.state_dict().items()})
        torch.save(src[0], tmp_path / "encoder.pth")
        # torch.hub modules save {'state_dict': ...}: read through it
        torch.save({"state_dict": src[1]}, tmp_path / "decoder.pth")
        args = ["--encoder", str(tmp_path / "encoder.pth"), "--decoder",
                str(tmp_path / "decoder.pth")]
    else:
        src = (fake_torchvggish_state_dict(rng) if kind == "vggish"
               else fake_lpips_state_dict(rng))
        torch.save(src, tmp_path / f"{kind}.pth")
        args = [f"--{kind}", str(tmp_path / f"{kind}.pth")]
    assert cli.main(["import-torch", *args, "--out", str(out)]) == 0
    return out, src


@pytest.mark.parametrize("kind", KINDS)
def test_cli_import_torch(kind, tmp_path):
    out, src = _import(kind, tmp_path)
    _, direct, _ = both_routes()
    if kind == "ldm":
        model = load_ldm(full_checkpoint=str(out), device="cpu",
                         dtype=torch.float32)
        for k, v in direct.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k
    elif kind == "autoencoder":
        params = ckpt.load_autoencoder(out)["params"]
        model = load_ldm(autoencoder_checkpoint=str(out), device="cpu",
                         dtype=torch.float32)
        for comp in ("encoder", "decoder"):
            for k, v in getattr(direct, comp).state_dict().items():
                assert torch.equal(params[comp][k], v), (comp, k)
                assert torch.equal(getattr(model, comp).state_dict()[k], v)
    else:
        payload = ckpt.load_feature_checkpoint(out)
        assert payload["kind"] == kind
        jax_convert = jax_convert_vggish if kind == "vggish" else \
            jax_convert_lpips
        want = jax_convert(_numpy(src))
        metric = build_feature_metric(kind, device="cpu",
                                      params=payload["params"])
        got = export_flax_convs(metric.module)
        flat = dict(jax.tree_util.tree_leaves_with_path(got))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            np.testing.assert_array_equal(flat[path], np.asarray(leaf))
        random = build_feature_metric(kind, device="cpu")
        a = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(0))
        b = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(1))
        assert metric.distance(a, b).item() != random.distance(a, b).item()


def _png_folder(root):
    rng = np.random.RandomState(8)
    for label, n in (("classic", 3), ("rock", 2)):
        (root / label).mkdir(parents=True)
        for i in range(n):
            img = rng.randint(0, 256, (128, 128)).astype(np.uint8)
            (root / label / f"{i:03d}.png").write_bytes(write_png_gray(img))
    return root


def test_cli_trains_the_ldm_from_imported_weights(tmp_path, capsys):
    """cli train --model ldm --pretrained-ae --style-features
    --compression-features at the default config on the CPU (one step over
    two pairs): the frozen encoder in ldm_final.pt is the imported one, bit
    for bit; a feature checkpoint of the wrong kind is refused."""
    ae, _ = _import("autoencoder", tmp_path)
    vggish, _ = _import("vggish", tmp_path)
    lpips, _ = _import("lpips", tmp_path)
    root = _png_folder(tmp_path / "img")
    pairs = tmp_path / "pairs.csv"
    assert cli.main(["generate-pairings", "--root", str(root), "--output",
                     str(pairs), "--num-pairs", "2"]) == 0
    args = ["train", "--model", "ldm", "--data-root", str(root),
            "--pairing-file", str(pairs), "--device", "cpu"]
    assert cli.main(args + [
        "--epochs", "1", "--out-dir", str(tmp_path / "run"),
        "--pretrained-ae", str(ae), "--style-features", str(vggish),
        "--compression-features", str(lpips)]) == 0
    out = capsys.readouterr().out
    assert "transplanted vggish feature weights" in out
    assert "transplanted lpips feature weights" in out
    final = ckpt.load_checkpoint(tmp_path / "run" / "ldm_final.pt")
    assert final["step"] == 1
    params = ckpt.load_autoencoder(ae)["params"]
    for k, v in params["encoder"].items():
        assert torch.equal(final["params"][f"encoder.{k}"], v), k
    assert not torch.equal(final["params"]["decoder.deconv1.weight"],
                           params["decoder"]["deconv1.weight"])
    with pytest.raises(SystemExit, match="holds 'lpips' weights"):
        cli.main(args + ["--style-features", str(lpips)])
    with pytest.raises(SystemExit, match="holds 'vggish' weights"):
        cli.main(args + ["--compression-features", str(vggish)])
