"""The port's evaluation and diagnostics against the JAX package's (f32
unless stated, CPU).

The trunk metrics get the same VGGish weights on both sides: JAX's
``PRNGKey(seed)`` init, carried to the port through
``interop/flax_weights.py load_flax_convs`` (the port's own seeded trunks
come from PyTorch's generator and differ from JAX's by design).  Images
are 16x16: the trunk stays cheap on the CPU, and its per-layer sums stay
short enough for the 1e-5 bar (at 64x64 XLA's CPU sums are the looser
side, ``tests/test_torch_losses.py`` FULL_WIDTH_TOL); the metrics do not
depend on the size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu import cli as jax_cli
from music_style_transfer_ldm_tpu import evaluation as jev
from music_style_transfer_ldm_tpu.evaluation import metrics as jmetrics
from music_style_transfer_ldm_tpu.losses.feature import (
    build_feature_metric as jax_feature_metric,
)
from music_style_transfer_ldm_tpu.losses.vggish import (
    VGGishFeatures as JaxVGGish,
)
from music_style_transfer_ldm_tpu.models.ldm import LDM as JaxLDM
from music_style_transfer_ldm_tpu.training import checkpoint as jax_ckpt
from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch import evaluation as ev
from music_style_transfer_ldm_tpu_torch.evaluation import metrics
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_variables, load_flax_convs,
)
from music_style_transfer_ldm_tpu_torch.losses.vggish import VGGishFeatures
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
from music_style_transfer_ldm_tpu_torch.training.checkpoint import (
    save_checkpoint,
)
from music_style_transfer_ldm_tpu_torch.utils.png import read_png_gray

RTOL_NUMPY = 1e-10     # the same numpy code on the same sets
RTOL_TRUNK = 1e-5      # embeddings and raw VGGish distances, f32
SEEDS = (11, 29)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sets():
    """Content, style and a transfer between them ([N, H, W, 1]), and a
    second style draw as the corpus."""
    rng = np.random.RandomState(7)
    content = rng.rand(6, 16, 16, 1).astype(np.float32)
    prof = np.linspace(1.0, 0.1, 16)[None, :, None, None]
    style = (rng.rand(6, 16, 16, 1) * prof).astype(np.float32)
    transfer = (0.4 * content + 0.6 * style).astype(np.float32)
    corpus = (rng.rand(6, 16, 16, 1) * prof).astype(np.float32)
    return content, style, transfer, corpus


@pytest.fixture(scope="module")
def trunks():
    """{seed: port VGGish state dict} holding JAX's PRNGKey(seed) trunk."""
    out = {}
    for seed in SEEDS:
        params = JaxVGGish().init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, 16, 16, 1)))["params"]
        module = VGGishFeatures()
        load_flax_convs(module, jax.tree_util.tree_map(np.asarray, params))
        out[seed] = module.state_dict()
    return out


def _rel(got, want):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))
                  / np.maximum(np.abs(np.asarray(want)), 1e-30))


# ---------------- the numpy metrics ----------------------------------------


@pytest.mark.parametrize("name", ["band_statistics", "log_mel_stats_distance",
                                  "batch_spectral_convergence",
                                  "frechet_distance", "shape_metric"])
def test_numpy_metrics_match_jax(sets, name):
    content, style, transfer, _ = sets
    if name == "band_statistics":
        got, want = metrics.band_statistics(transfer), \
            jmetrics.band_statistics(transfer)
        for k in ("mean", "std"):
            assert _rel(got[k], want[k]) <= RTOL_NUMPY
        return
    if name == "frechet_distance":
        rng = np.random.RandomState(3)
        a, b = rng.randn(12, 5), rng.randn(12, 5) + 0.3
        args, fns = (a, b), (metrics.frechet_distance,
                             jmetrics.frechet_distance)
    elif name == "shape_metric":
        args = (metrics._zscore_set(transfer), metrics._zscore_set(style))
        np.testing.assert_allclose(args[0], jmetrics._zscore_set(transfer),
                                   rtol=RTOL_NUMPY)
        fns = (metrics.log_mel_stats_distance,
               jmetrics.log_mel_stats_distance)
    else:
        args = (transfer, content)
        fns = (getattr(metrics, name), getattr(jmetrics, name))
    got, want = (fn(*args) for fn in fns)
    assert got > 0 and _rel(got, want) <= RTOL_NUMPY


# ---------------- the trunk metrics ----------------------------------------


def test_trunk_embeddings_match_jax(sets, trunks):
    content = sets[0]
    got = metrics.trunk_embeddings(content, seed=11, device="cpu",
                                   params=trunks[11])
    want = jmetrics.trunk_embeddings(content, seed=11)
    assert got.shape == (6, 512) and got.dtype == np.float64
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= RTOL_TRUNK * top


def test_style_distances_match_jax(sets, trunks):
    content, style, transfer, _ = sets
    got = metrics.style_distances_multiseed(content, style, transfer,
                                            SEEDS, device="cpu",
                                            trunks=trunks)
    for seed in SEEDS:
        m = jax_feature_metric("vggish", dtype=jnp.float32)
        m.init(seed=seed, input_shape=(1, 16, 16, 1))
        want = (float(m.distance(m.params, jnp.asarray(content),
                                 jnp.asarray(style))),
                float(m.distance(m.params, jnp.asarray(transfer),
                                 jnp.asarray(style))))
        assert _rel(got[seed], want) <= RTOL_TRUNK, (seed, got, want)


def test_fad_metrics_match_jax(sets, trunks):
    content, _, transfer, corpus = sets
    got = metrics.fad_metrics(content, transfer, corpus, device="cpu",
                              trunks=trunks)
    assert got == jmetrics.fad_metrics(content, transfer, corpus)


def test_independent_transfer_metrics_match_jax(sets, trunks):
    """Every key, the multi-seed VGGish reductions and the FAD block
    included, equal after its own rounding."""
    content, style, transfer, corpus = sets
    got = metrics.independent_transfer_metrics(
        content, style, transfer, style_corpus=corpus, seeds=SEEDS,
        device="cpu", trunks=trunks)
    want = jmetrics.independent_transfer_metrics(
        content, style, transfer, style_corpus=corpus, seeds=SEEDS)
    assert got == want
    assert got["vggish_multiseed_style_reduction_pct"][11] > 0


def test_seeded_trunks_are_the_port_s_own(sets):
    """Without given weights each seed is a PyTorch-seeded trunk:
    deterministic, and different from the other seed's."""
    content = sets[0]
    a = metrics.trunk_embeddings(content, seed=11, device="cpu")
    b = metrics.trunk_embeddings(content, seed=11, device="cpu")
    c = metrics.trunk_embeddings(content, seed=29, device="cpu")
    assert np.array_equal(a, b) and not np.allclose(a, c)


# ---------------- diagnostics ----------------------------------------------


@pytest.fixture(scope="module")
def ldm_pair():
    """The port's seed-0 LDM at full width and the JAX LDM on its
    weights."""
    port = build_ldm(device="cpu", seed=0)
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       export_flax_variables(port))
    return port, JaxLDM(latent_dim=32), variables


def test_parameter_table_matches_jax(ldm_pair):
    port, _, variables = ldm_pair
    table = ev.parameter_table(port)
    assert table["encoder"] == 111840
    assert table["decoder"] == 198209
    assert table["style_encoder"] == 2729984
    want = jev.parameter_table(variables["params"])
    assert list(table.items()) == list(want.items())


def test_style_embedding_stats_match_jax(ldm_pair):
    port, jldm, variables = ldm_pair
    styles = np.random.RandomState(0).rand(4, 128, 128, 1).astype(np.float32)
    with torch.no_grad():
        embs = port.style_embed(torch.tensor(styles))
    jembs = jldm.apply(variables, jnp.asarray(styles),
                       method=JaxLDM.style_embed)
    got, want = ev.style_embedding_stats(embs), jev.style_embedding_stats(
        jembs)
    assert list(got) == list(want)
    for k in want:
        for stat in ("mean", "std", "zero_fraction"):
            np.testing.assert_allclose(got[k][stat], want[k][stat],
                                       rtol=1e-5, atol=1e-7)
    assert ev.detect_dead_style_encoder(embs) == \
        jev.detect_dead_style_encoder(jembs)
    assert not any(ev.detect_dead_style_encoder(embs).values())
    dead = {k: torch.zeros_like(v) for k, v in embs.items()}
    assert all(ev.detect_dead_style_encoder(dead).values())


def test_spectral_convergence_matches_jax():
    rng = np.random.RandomState(5)
    m = rng.rand(128, 50).astype(np.float32)
    g = (m + 0.1 * rng.randn(128, 50)).astype(np.float32)
    got = ev.spectral_convergence(m, g, device="cpu")
    assert abs(got - jev.spectral_convergence(m, g)) <= 1e-6
    assert ev.spectral_convergence(m, m, device="cpu") == 0.0


def test_mel_db_distance_matches_jax():
    rng = np.random.RandomState(6)
    a = (0.1 * rng.randn(22050)).astype(np.float32)
    b = (0.1 * rng.randn(22050)).astype(np.float32)
    got = ev.mel_db_distance(a, b, device="cpu")
    assert got > 1.0 and abs(got - jev.mel_db_distance(a, b)) <= 1e-4
    assert ev.mel_db_distance(a, a, device="cpu") == 0.0


def _one_step(got: np.ndarray, want: np.ndarray) -> None:
    """uint8 images equal but for one step on at most 1e-3 of pixels."""
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


@pytest.fixture(scope="module")
def forward_outputs():
    rng = np.random.RandomState(8)
    outputs = {k: rng.randn(2, 16, 16, 32).astype(np.float32)
               for k in ("z_t", "noise", "noise_pred", "z_0")}
    outputs["reconstructed"] = rng.rand(2, 128, 128, 1).astype(np.float32)
    content = rng.rand(2, 128, 128, 1).astype(np.float32)
    style = rng.rand(2, 128, 128, 1).astype(np.float32)
    return outputs, content, style


def test_reconstruction_grid_matches_jax(tmp_path, forward_outputs):
    outputs, content, _ = forward_outputs
    got = ev.reconstruction_grid(content, outputs["reconstructed"],
                                 out_path=str(tmp_path / "grid.png"))
    want = jev.reconstruction_grid(content, outputs["reconstructed"])
    assert got.shape == (2 * 128, 2 * 128)
    _one_step(got, np.asarray(want))
    assert np.array_equal(read_png_gray((tmp_path / "grid.png").read_bytes()),
                          got)


def test_forward_visualization_matches_jax(tmp_path, forward_outputs):
    outputs, _, _ = forward_outputs
    got = ev.forward_visualization({k: torch.tensor(v)
                                    for k, v in outputs.items()},
                                   out_path=str(tmp_path / "port.png"))
    want = jev.forward_visualization(
        {k: jnp.asarray(v) for k, v in outputs.items()},
        out_path=str(tmp_path / "jax.png"))
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], rtol=1e-6)
    _one_step(read_png_gray((tmp_path / "port.png").read_bytes()),
              read_png_gray((tmp_path / "jax.png").read_bytes()))


def test_ldm_forward_panel_matches_jax(tmp_path, forward_outputs):
    outputs, content, style = forward_outputs
    ev.ldm_forward_panel({k: torch.tensor(v) for k, v in outputs.items()},
                         content, style, str(tmp_path / "port.png"), item=1)
    jev.ldm_forward_panel({k: jnp.asarray(v) for k, v in outputs.items()},
                          content, style, str(tmp_path / "jax.png"), item=1)
    got = read_png_gray((tmp_path / "port.png").read_bytes())
    assert got.shape == (128, 4 * 128)
    _one_step(got, read_png_gray((tmp_path / "jax.png").read_bytes()))


# ---------------- cli diagnose ---------------------------------------------


def _diagnose_lines(text: str):
    return [ln for ln in text.splitlines()
            if ln.startswith("  ") or ln.endswith(":")]


def test_cli_diagnose_prints_jax_s_table_and_levels(tmp_path, capsys,
                                                    ldm_pair):
    """The same weights through both commands: the same table, the same
    levels and flags; each std within 2 % (both embed in bf16, as their
    load_ldm's default type, rounded at other points)."""
    port, _, variables = ldm_pair
    save_checkpoint(tmp_path / "port.pt", port)
    jax_ckpt.save_pytree(tmp_path / "jax_ckpt", {
        "params": jax.tree_util.tree_map(np.asarray, variables["params"]),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              variables["batch_stats"]),
        "format_version": np.asarray(jax_ckpt.FORMAT_VERSION)})
    capsys.readouterr()
    assert cli.main(["diagnose", "--checkpoint", str(tmp_path / "port.pt"),
                     "--device", "cpu"]) == 0
    got = _diagnose_lines(capsys.readouterr().out)
    assert jax_cli.main(["diagnose", "--checkpoint",
                         str(tmp_path / "jax_ckpt")]) == 0
    want = _diagnose_lines(capsys.readouterr().out)
    table = 1 + len(ev.parameter_table(port))
    assert got[:table] == want[:table]
    assert len(got) == len(want) == table + 1 + 6
    for g, w in zip(got[table + 1:], want[table + 1:]):
        gk, wk = g.split(), w.split()
        assert gk[0] == wk[0] and gk[3:] == wk[3:]      # level, DEAD flag
        gs, ws = (float(x.split("=")[1]) for x in (gk[1], wk[1]))
        gz, wz = (float(x.split("=")[1]) for x in (gk[2], wk[2]))
        assert abs(gs - ws) <= 0.02 * ws and abs(gz - wz) <= 0.01
    assert "DEAD" not in "".join(got)


def test_diagnose_parser_is_jax_s_plus_device():
    def actions(parser):
        sub = parser._subparsers._group_actions[0].choices["diagnose"]
        return {a.dest: (tuple(a.option_strings), a.default, a.required)
                for a in sub._actions if a.dest != "help"}
    got = actions(cli.build_parser())
    assert got.pop("device") == (("--device",), "cuda", False)
    assert got == actions(jax_cli.build_parser())
