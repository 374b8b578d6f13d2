"""The port's benchmark (``benchmarks.py``, ``cli bench``) against the
JAX package's (CPU).

The JSON line: the same fields print the same line through both
``Emitter``s, and the port's sections set exactly the JAX key set, in
the JAX sections' order.  The work: the port's FLOP count of a denoiser
call and of an LDM training step at full width against XLA's count of
the same functions.  The method: the chain length on the card, the
headline chain equal to sequential plain trajectories, no run without
a card unless asked, and no section failure caught.
"""

import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu import benchmarks as jbench
from music_style_transfer_ldm_tpu.config import default_config as jax_config
from music_style_transfer_ldm_tpu.models.ldm import (
    LDM as JaxLDM, _denoise_fn as jax_denoise_fn,
)
from music_style_transfer_ldm_tpu.training import LDMTrainer as JaxTrainer
from music_style_transfer_ldm_tpu_torch import benchmarks as bench
from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (
    transfer_time_grid,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import (
    _denoise_fn, build_ldm,
)
from music_style_transfer_ldm_tpu_torch.ops.fused_sampler import (
    fused_ddim_sample, pack_operands, reference_ddim_sample,
)
from music_style_transfer_ldm_tpu_torch.training.train_ldm import LDMTrainer
from music_style_transfer_ldm_tpu_torch.utils.chips import bench_chain_len

JAX_BENCH = Path(jbench.__file__)
B = 2          # the FLOP counts' batch, at the flagship's full width


def _emit_both(capsys, calls) -> tuple:
    lines = []
    for emitter in (jbench.Emitter(), bench.Emitter()):
        for method, args, kw in calls:
            getattr(emitter, method)(*args, **kw)
        emitter.emit()
        lines.append(capsys.readouterr().out)
    return tuple(lines)


def test_emitter_prints_the_jax_line(capsys, tmp_path, monkeypatch):
    # JAX's Emitter reads its banked line from here: a missing file, so
    # it reads nothing of the repo (and on the CPU backend writes none)
    monkeypatch.setenv("MSTLDM_BENCH_LAST_GOOD", str(tmp_path / "none.json"))
    meta = ("set", (), dict(chip="NVIDIA H100 80GB HBM3",
                            chip_peak_tflops=989, methodology="m",
                            sync_floor_ms=0.0123, scan_step_ms=None))
    assert _emit_both(capsys, [meta]) == ("", "")     # no headline yet
    want, got = _emit_both(capsys, [
        meta, ("set_headline", (0.0912345678, "kernel A"), {}),
        ("set", (), dict(scan_step_ms=1.23456, mfu_train_b128=0.0123,
                         transfer_b64_dpm25_clips_per_s=812)),
        ("set_headline", (0.0901234567, "kernel A"), {})])
    assert want and got == want
    line = json.loads(got)
    assert list(line)[:4] == list(bench.HEADLINE_KEYS)
    assert line["value"] == 0.0901 and line["vs_baseline"] == 554.79


def _jax_sections() -> list:
    """(name, fields) of the JAX ``main``'s ``sections`` list, read with
    ``ast``."""
    for node in ast.walk(ast.parse(JAX_BENCH.read_text())):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "sections"):
            return [(e.elts[0].value, tuple(f.value for f in e.elts[1].elts))
                    for e in node.value.elts]
    raise AssertionError("no sections list in the JAX benchmark")


def test_keys_and_sections_are_the_jax_ones():
    jax_keys = (("metric", "value", "unit", "vs_baseline")
                + jbench.Emitter._SECONDARY_KEYS)
    assert bench.HEADLINE_KEYS + bench.Emitter._SECONDARY_KEYS == jax_keys
    # the headline is its own section here (JAX measures it before its
    # list); then the JAX list, name for name and key for key
    assert bench.SECTIONS[0] == ("fused chain", ("value",))
    assert list(bench.SECTIONS[1:]) == _jax_sections()


def _abstract_jax_trainer():
    """JAX's LDM trainer with the style term's gradient on (the bench's
    recipe), its state and feature parameters as shapes only: counting
    needs no values, and a concrete init takes a minute on the CPU."""
    cfg = jax_config()
    cfg.train = dataclasses.replace(cfg.train,
                                    style_loss_stop_gradient=False)
    tr = JaxTrainer(cfg)
    x = jnp.zeros((1, 128, 128, 1))
    for metric, args in ((tr.compression_feature, (x, x)),
                         (tr.style_feature, (x,))):
        metric.params = jax.eval_shape(
            lambda m=metric, a=args: m.module.init(jax.random.PRNGKey(0),
                                                   *a)["params"])
    return tr, jax.eval_shape(tr.init_state, 0)


def test_flop_counts_follow_xla_at_full_width():
    """The port counts with torch's FlopCounterMode, the JAX package with
    XLA's cost analysis.  The port's count sits higher, by a share fixed
    by the shapes: FlopCounterMode counts every tap of a padded 3x3
    convolution, XLA only the taps inside the image (((3h - 2) / 3h)^2 of
    them on an h x h map: 0.92 at 16, 0.69 at 4, 0.44 at 2, where the
    UNet's pyramid ends), and XLA also counts the elementwise work
    (activations, norms, Adam), which FlopCounterMode does not.  The
    denoiser runs on 16x16 to 2x2 maps: 1.090 of XLA's at B=2; the
    training step is mostly the VGGish and LPIPS trunks on 128x128 to
    16x16 maps, where the elementwise work nearly cancels the padding:
    1.035."""
    rs = np.random.RandomState(0)
    content = rs.rand(B, 128, 128, 1).astype(np.float32)
    style = rs.rand(B, 128, 128, 1).astype(np.float32)
    shape = jax.ShapeDtypeStruct

    jmodel = JaxLDM(dtype=jnp.bfloat16)
    x1 = jnp.zeros((1, 128, 128, 1))
    variables = jax.eval_shape(
        jmodel.init, {"params": jax.random.PRNGKey(0),
                      "diffusion": jax.random.PRNGKey(1)},
        x1, x1, jnp.zeros((1,), jnp.int32))
    jemb = jax.eval_shape(
        lambda v, s: jmodel.apply(v, s, method=JaxLDM.style_embed),
        variables, shape((B, 128, 128, 1), jnp.float32))
    want_denoise = jbench._flops(
        jax.jit(lambda v, e, z, t: jax_denoise_fn(jmodel, v, e)(z, t)),
        variables, jemb, shape((B, 16, 16, 32), jnp.float32),
        shape((B,), jnp.int32))

    ldm = build_ldm(device="cpu", seed=0)
    emb = ldm.style_encoder(torch.tensor(style).permute(0, 3, 1, 2))
    got_denoise = bench._flops(_denoise_fn(ldm, emb),
                               torch.zeros(B, 32, 16, 16),
                               torch.zeros(B, dtype=torch.long))
    assert 1.05 <= got_denoise / want_denoise <= 1.15

    jtr, jstate = _abstract_jax_trainer()
    img = shape((B, 128, 128, 1), jnp.float32)
    want_step = jbench._flops(jtr._train_step, jstate, img, img,
                              jax.random.PRNGKey(9), jtr._feature_params())
    cfg = default_config()
    cfg.train = dataclasses.replace(cfg.train,
                                    style_loss_stop_gradient=False)
    tr = LDMTrainer(cfg, device="cpu", feature_impl="plain")
    got_step = bench._flops(tr._step, tr.init_state(0),
                            torch.tensor(content), torch.tensor(style))
    assert 1.0 <= got_step / want_step <= 1.07
    assert bench._mfu(got_step, 0.5, 2 * got_step) == 1.0
    assert bench._mfu(None, 0.5, 1.0) is None
    assert bench._peak_flops_per_sec("cpu") is None


@pytest.mark.parametrize("kind,base,want", [
    ("NVIDIA H100 80GB HBM3", 32, 32),      # 32 x 4.45 ms: a 142 ms window
    ("NVIDIA H100 PCIe", 32, 32),           # not scaled by the peak
    ("NVIDIA H100 80GB HBM3", 512, 512),    # the caller's base
    ("cpu", 32, 32), (None, 5, 5)])         # unknown: the base
def test_bench_chain_len(kind, base, want):
    assert bench_chain_len(kind, base) == want
    if base == 32:
        assert bench_chain_len(kind) == want


def test_no_run_without_the_card(tmp_path, monkeypatch):
    """No silent CPU: without a card the bench raises unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MSTLDM_KERNEL_BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])
    assert cli.build_parser().parse_args(
        ["bench", "--device", "cpu"]).device == "cpu"


def test_headline_chain_is_sequential_trajectories():
    """The headline's chain at N=2 on the CPU (kernel A's plain version)
    is two trajectories in a row, the second from the first's output,
    bit for bit."""
    ldm = build_ldm(device="cpu", dtype=torch.bfloat16, seed=0)
    rs = np.random.RandomState(1)
    style = torch.tensor(rs.rand(1, 128, 128, 1).astype(np.float32))
    z0 = torch.tensor(rs.randn(1, 16, 16, 32).astype(np.float32))
    emb = ldm.style_embed(style)
    grid = transfer_time_grid(bench.STEPS)
    launches = fused_ddim_sample.launches
    got = bench.fused_chain(ldm, emb, grid, z0, 2)
    ops = pack_operands(ldm.unet, emb, ldm.schedule, grid, 0.0)
    n = len(grid) - 1
    want = reference_ddim_sample(ops, reference_ddim_sample(ops, z0, n), n)
    assert torch.equal(got, want)
    assert not torch.equal(got, reference_ddim_sample(ops, z0, n))
    assert fused_ddim_sample.launches == launches    # the CPU launches none


def test_a_failing_section_stops_the_run_after_its_fields(capsys,
                                                         monkeypatch):
    """No section failure is caught: the run raises after printing the
    fields measured so far (here the headline, before the scan chain's
    failure), at a cut depth on the CPU."""
    monkeypatch.setattr(bench, "STEPS", 4)
    timed = bench.timed
    monkeypatch.setattr(bench, "timed", lambda fn, *a, **kw: timed(
        fn, *a, repeats=1, warmup=0, device=kw["device"]))
    monkeypatch.setattr(bench.Emitter, "install_kill_handler",
                        lambda self: None)

    def broken(*args, **kwargs):
        raise RuntimeError("scan sampler broke")

    monkeypatch.setattr(bench, "ddim_sample", broken)
    with pytest.raises(RuntimeError, match="scan sampler broke"):
        bench.main(device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "ddim_step_ms" and line["value"] > 0
    assert line["chip"] == "cpu" and "scan_step_ms" not in line
