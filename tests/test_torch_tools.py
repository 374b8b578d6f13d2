"""The port's measurement and evaluation tools (``tools/torch_*.py``)
against the JAX package's (CPU, small).

* Record keys: each tool's keys, read from its source with ``ast``,
  are the JAX tool's plus the extras it declares (``EXTRA_KEYS``).
* Load curve: the level summary on scripted timestamps equals the JAX
  tool's formulas (its own lines, run here); one real curve on the CPU
  answers every request.
* Roofline: the byte counter is exact on a matmul and a conv; the FLOP
  counts of three stages follow XLA's at B=2.
* Eval tools: on the same arrays, with the JAX package's seeded VGGish
  trunks carried to the port (``interop/flax_weights.py``), every metric
  equals the JAX tool's computation within 1e-4 relative and one unit
  of the record's last rounded digit; each tool also runs end to end on
  a tiny pack with a random port checkpoint, and ``summarize_evals`` /
  ``summarize_sweep`` read its output.
* Full-scale run: ``prepare_dataset`` and ``measure_pipeline`` at a toy
  size.
"""

import ast
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from music_style_transfer_ldm_tpu import benchmarks as jbench
from music_style_transfer_ldm_tpu.evaluation import metrics as jmetrics
from music_style_transfer_ldm_tpu.losses.feature import (
    build_feature_metric as jax_feature_metric,
)
from music_style_transfer_ldm_tpu.losses.vggish import (
    VGGishFeatures as JaxVGGish,
)
from music_style_transfer_ldm_tpu.models.ldm import (
    LDM as JaxLDM, match_moments as jax_match_moments,
)
from music_style_transfer_ldm_tpu_torch import benchmarks as bench
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.datasets import PackedBatchLoader
from music_style_transfer_ldm_tpu_torch.datasets.packed import (
    PackedPairDataset, write_pack,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    load_flax_convs,
)
from music_style_transfer_ldm_tpu_torch.losses.vggish import VGGishFeatures
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
from music_style_transfer_ldm_tpu_torch.training import LDMTrainer
from music_style_transfer_ldm_tpu_torch.training.checkpoint import (
    save_checkpoint,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tools import (  # noqa: E402
    summarize_evals, summarize_sweep, torch_eval_distill_fidelity,
    torch_eval_generate, torch_eval_transfer, torch_fullscale_run,
    torch_roofline_b64, torch_serving_load_curve,
)
from tools import eval_generate as jax_eval_generate  # noqa: E402

TOOLS = REPO / "tools"
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------- record keys ------------------------------------------------


def _keys(path: Path, name: str) -> set:
    """String keys that ``path``'s source gives the record ``name``: dict
    literals assigned to it, ``name[k] = ...`` stores, ``name.update(
    {...})`` calls, and dicts returned by a function called ``name``."""
    keys = set()

    def take(node):
        if isinstance(node, ast.Dict):
            keys.update(k.value for k in node.keys
                        if isinstance(k, ast.Constant))
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and t.id == name:
                    take(node.value)
                elif (isinstance(t, ast.Subscript)
                      and getattr(t.value, "id", None) == name
                      and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"
              and getattr(node.func.value, "id", None) == name):
            for a in node.args:
                take(a)
        elif isinstance(node, ast.FunctionDef) and node.name == name:
            for r in ast.walk(node):
                if isinstance(r, ast.Return):
                    take(r.value)
    return keys


# (JAX tool, its record names) -> (port tool, its record names)
KEY_SETS = [
    ("serving_load_curve.py", ("drive_level",),
     "torch_serving_load_curve.py", ("summarize_level",)),
    ("serving_load_curve.py", ("run_curve",),
     "torch_serving_load_curve.py", ("run_curve",)),
    ("serving_load_curve.py", ("record",),
     "torch_serving_load_curve.py", ("record",)),
    ("roofline_b64.py", ("entry",),
     "torch_roofline_b64.py", ("roofline_entry",)),
    ("roofline_b64.py", ("record",), "torch_roofline_b64.py", ("record",)),
    ("eval_transfer.py", ("results",),
     "torch_eval_transfer.py", ("results", "transfer_metrics")),
    ("eval_generate.py", ("results",),
     "torch_eval_generate.py", ("results", "generation_metrics")),
    ("eval_distill_fidelity.py", ("results", "fid"),
     "torch_eval_distill_fidelity.py", ("results", "fidelity")),
    ("fullscale_run.py", ("result", "meas"),
     "torch_fullscale_run.py", ("result", "meas")),
]
EXTRAS = {"torch_serving_load_curve.py":
          set(torch_serving_load_curve.EXTRA_KEYS),
          "torch_roofline_b64.py": set(torch_roofline_b64.EXTRA_KEYS),
          "torch_fullscale_run.py": set(torch_fullscale_run.EXTRA_KEYS)}


@pytest.mark.parametrize("jax_tool,jax_names,port_tool,port_names",
                         KEY_SETS, ids=[f"{k[0]}:{k[1][0]}" for k in KEY_SETS])
def test_record_keys_are_the_jax_tools(jax_tool, jax_names, port_tool,
                                       port_names):
    want = set().union(*(_keys(TOOLS / jax_tool, n) for n in jax_names))
    got = set().union(*(_keys(TOOLS / port_tool, n) for n in port_names))
    assert want, jax_tool
    extra = EXTRAS.get(port_tool, set())
    assert got - extra == want, (sorted(got - extra - want),
                                 sorted(want - got))


# ---------------- the load curve ---------------------------------------------


def _jax_level_summary():
    """The JAX tool's own summary lines (``drive_level`` from its ``lats
    = ...`` to its return) as a function of the level's inputs."""
    src = (TOOLS / "serving_load_curve.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "drive_level")
    start = next(i for i, s in enumerate(fn.body)
                 if isinstance(s, ast.Assign)
                 and getattr(s.targets[0], "id", None) == "lats")
    args = ast.parse("def f(rate_per_s, n_sent, results, t0, t_sent_end, "
                     "t_end): pass").body[0]
    args.body = fn.body[start:]
    module = ast.fix_missing_locations(ast.Module([args], []))
    space: dict = {}
    exec(compile(module, "serving_load_curve.py", "exec"), space)
    return space["f"]


@pytest.mark.parametrize("case", ["mixed", "errors_only", "one"])
def test_level_summary_is_the_jax_formula(case):
    rng = np.random.RandomState(3)
    sched = np.cumsum(rng.exponential(0.01, 200))
    done = sched + rng.gamma(2.0, 0.02, 200)
    err = rng.rand(200) < 0.05
    results = {"mixed": list(zip(sched, done, err)),
               "errors_only": [(0.0, 0.1, True), (0.1, 0.3, True)],
               "one": [(0.5, 0.9, False)]}[case]
    args = (123.456, len(results) + 3, results, 0.0, 2.0, 2.75)
    want = _jax_level_summary()(*args)
    assert torch_serving_load_curve.summarize_level(*args) == want


def test_load_curve_answers_every_request_on_the_cpu(tmp_path):
    out = tmp_path / "curve.json"
    assert torch_serving_load_curve.main(
        ["--device", "cpu", "--loads", "4", "--seconds", "1", "--steps",
         "2", "--sample-steps", "2", "--buckets", "1,2", "--autoscale",
         "off", "--out", str(out)]) == 0
    record = json.loads(out.read_text())
    assert record["backend"] == "cpu" and record["power_limit"] is None
    (run,) = record["runs"]
    (level,) = run["levels"]
    assert level["sent"] > 0
    assert level["completed"] == level["sent"] and level["errors"] == 0
    assert set(level) == _keys(TOOLS / "serving_load_curve.py",
                               "drive_level") | {"stats"}


# ---------------- the roofline -----------------------------------------------


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("op", ["matmul", "conv"])
def test_byte_counter_is_inputs_plus_outputs(op):
    g = torch.Generator().manual_seed(0)
    if op == "matmul":
        a, b = torch.randn(64, 32, generator=g), torch.randn(32, 16,
                                                             generator=g)
        ins, fn = (a, b), lambda: a @ b
    else:
        x = torch.randn(2, 3, 8, 8, generator=g)
        w, bias = torch.randn(4, 3, 3, 3, generator=g), torch.randn(4)
        ins, fn = (x, w, bias), lambda: F.conv2d(x, w, bias, padding=1)
    with torch.no_grad(), torch_roofline_b64.ByteCounter() as counter:
        out = fn()
    assert counter.bytes == _nbytes(*ins, out)


def test_stage_flops_follow_xla():
    """FlopCounterMode counts every padded tap and no elementwise work;
    XLA counts the taps inside the image and the elementwise work too.
    On the encoders' 128x128 to 16x16 maps the two nearly cancel: the
    style encoder and the decoder read 1.02-1.03 of XLA's count, the VAE
    encoder 0.997 (its BatchNorm and activations outweigh its padding),
    so the band is [0.99, 1.10]."""
    B = 2
    jmodel = JaxLDM(dtype=jnp.bfloat16)
    x1 = jnp.zeros((1, 128, 128, 1))
    variables = jax.eval_shape(
        jmodel.init, {"params": jax.random.PRNGKey(0),
                      "diffusion": jax.random.PRNGKey(1)},
        x1, x1, jnp.zeros((1,), jnp.int32))
    img = jax.ShapeDtypeStruct((B, 128, 128, 1), jnp.float32)
    lat = jax.ShapeDtypeStruct((B, 16, 16, 32), jnp.float32)
    ldm = build_ldm(device="cpu", dtype=torch.bfloat16)
    rs = np.random.RandomState(0)
    im = torch.tensor(rs.rand(B, 128, 128, 1).astype(np.float32))
    z = torch.tensor(rs.rand(B, 16, 16, 32).astype(np.float32))
    for method, shape, fn, arg in (
            (JaxLDM.style_embed, img, ldm.style_embed, im),
            (JaxLDM.encode, img, ldm.encode, im),
            (JaxLDM.decode, lat, ldm.decode, z)):
        want = jbench._flops(jax.jit(
            lambda v, a, m=method: jmodel.apply(v, a, method=m)),
            variables, shape)
        with torch.no_grad():
            got = bench._flops(fn, arg)
        assert 0.99 <= got / want <= 1.10, (method.__name__, got / want)


def test_roofline_entry_bound():
    e = torch_roofline_b64.roofline_entry(1e-3, 2e9, 1e8, 1e15, 1e12,
                                          kernel_s=4e-4)
    # intensity 20 FLOP/B x 1 TB/s = 20 TFLOP/s < the 1,000 peak
    assert e["bound_by"] == "hbm" and e["roofline_bound_tflops"] == 20.0
    assert e["achieved_tflops"] == 2.0 and e["pct_of_roofline"] == 0.1
    assert e["kernel_ms"] == 0.4 and e["idle_share"] == 0.6


# ---------------- the eval tools' metrics ------------------------------------


def _close(got, want, key="") -> None:
    """Equal within RTOL relative plus one unit of the record's rounding
    (0.1 for percentages, 1e-6 for the log-mel distances, else 1e-4)."""
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _close(got[k], want[k], f"{key}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), key
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{key}[{i}]")
    elif isinstance(want, str):
        assert isinstance(got, str), key
    else:
        unit = (0.1 if "pct" in key else 1e-6 if "logmel" in key
                else 1e-4)
        assert abs(got - want) <= RTOL * abs(want) + unit, (key, got, want)


@pytest.fixture(scope="module")
def trunks():
    """{seed: port VGGish state dict} holding JAX's PRNGKey(seed) trunk,
    for the three seeds the tools use."""
    out = {}
    for seed in (3, 11, 29):
        params = JaxVGGish().init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, 16, 16, 1)))["params"]
        module = VGGishFeatures()
        load_flax_convs(module, jax.tree_util.tree_map(np.asarray, params))
        out[seed] = module.state_dict()
    return out


@pytest.fixture(scope="module")
def sets():
    """[6, 16, 16, 1] content, style, a transfer between them, the AE's
    'reconstruction', and a second style draw."""
    rng = np.random.RandomState(7)
    content = rng.rand(6, 16, 16, 1).astype(np.float32)
    prof = np.linspace(1.0, 0.1, 16)[None, :, None, None]
    style = (rng.rand(6, 16, 16, 1) * prof).astype(np.float32)
    decoded = (0.4 * content + 0.6 * style).astype(np.float32)
    recon = np.clip(content + 0.05 * rng.randn(6, 16, 16, 1), 0,
                    1).astype(np.float32)
    corpus = (rng.rand(6, 16, 16, 1) * prof).astype(np.float32)
    return content, style, decoded, recon, corpus


def test_transfer_metrics_match_the_jax_tool(sets, trunks):
    """``tools/eval_transfer.py``'s metric block, computed here with the
    JAX package's functions exactly as that tool calls them."""
    content, style, decoded, recon, _ = sets

    def mse(a, b):
        return float(np.mean((a - b) ** 2))
    vgg = jax_feature_metric("vggish", dtype=jnp.float32)
    vgg.init(seed=3, input_shape=(1,) + content.shape[1:])

    def dist(a, b):
        return float(vgg.distance(vgg.params, jnp.asarray(a),
                                  jnp.asarray(b)))
    base, got = dist(content, style), dist(decoded, style)
    matched = np.asarray(jax_match_moments(jnp.asarray(decoded),
                                           jnp.asarray(style)))
    want = {
        "pixel_mse_transfer_vs_content": round(mse(decoded, content), 4),
        "pixel_mse_transfer_vs_content_recon": round(mse(decoded, recon),
                                                     4),
        "pixel_mse_recon_vs_content": round(mse(recon, content), 4),
        "pixel_mse_transfer_vs_style": round(mse(decoded, style), 4),
        "pixel_mse_content_vs_style_baseline": round(mse(content, style),
                                                     4),
        "vggish_distance_transfer_vs_style": round(got, 4),
        "vggish_distance_content_vs_style_baseline": round(base, 4),
        "style_distance_reduction_pct": round(100 * (1 - got / base), 1),
        "style_trunk_note": "",
        **jmetrics.independent_transfer_metrics(content, style, decoded,
                                                seeds=(11, 29)),
        "level_matched": jmetrics.independent_transfer_metrics(
            content, style, matched, seeds=(11, 29)),
    }
    _close(torch_eval_transfer.transfer_metrics(
        content, style, decoded, recon, "cpu", trunks=trunks), want)


def test_generation_metrics_match_the_jax_tool(sets, trunks):
    """``tools/eval_generate.py``'s FAD floor and ceiling, band
    statistics and spreads, with its own ``pairwise_spread``."""
    content, style, decoded, _, corpus = sets
    generated, corpus_a, corpus_b, mismatch = decoded, style, corpus, content
    emb = {k: jmetrics.trunk_embeddings(x, seed=11) for k, x in (
        ("gen", generated), ("a", corpus_a), ("b", corpus_b),
        ("o", mismatch))}
    want = {
        "fad_generated_vs_style_corpus": round(jmetrics.frechet_distance(
            emb["gen"], emb["a"]), 4),
        "fad_real_vs_real_floor": round(jmetrics.frechet_distance(
            emb["b"], emb["a"]), 4),
        "fad_other_class_ceiling": round(jmetrics.frechet_distance(
            emb["o"], emb["a"]), 4),
        "logmel_stats_distance_generated_vs_corpus": round(
            jmetrics.log_mel_stats_distance(generated, corpus_a), 6),
        "logmel_stats_distance_real_vs_real": round(
            jmetrics.log_mel_stats_distance(corpus_b, corpus_a), 6),
        "pairwise_spread_generated": round(
            jax_eval_generate.pairwise_spread(generated), 4),
        "pairwise_spread_real": round(
            jax_eval_generate.pairwise_spread(corpus_a), 4),
    }
    _close(torch_eval_generate.generation_metrics(
        generated, corpus_a, corpus_b, mismatch, "cpu", trunks=trunks),
        want)
    assert (torch_eval_generate.pairwise_spread(generated)
            == jax_eval_generate.pairwise_spread(generated))


def _jax_fid(ref):
    """``tools/eval_distill_fidelity.py``'s nested ``fid``, its own
    lines, bound to the reference output ``ref``."""
    src = (TOOLS / "eval_distill_fidelity.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "fid")
    space = {"np": np, "ref": ref}
    exec(compile(ast.fix_missing_locations(ast.Module([fn], [])),
                 "eval_distill_fidelity.py", "exec"), space)
    return space["fid"]


def test_fidelity_matches_the_jax_tool_exactly(sets):
    content, _, decoded, recon, _ = sets
    fid = _jax_fid(decoded)
    for x in (content, recon, decoded):
        assert torch_eval_distill_fidelity.fidelity(x, decoded) == fid(x)
    res = {"teacher_coarse": fid(content), "student_distilled": fid(recon)}
    want = round(100.0 * (1.0 - res["student_distilled"]["mse_vs_teacher50"]
                          / max(res["teacher_coarse"]["mse_vs_teacher50"],
                                1e-12)), 1)
    assert torch_eval_distill_fidelity.mse_reduction_pct(res) == want


# ---------------- the eval tools end to end ----------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A 16-image pack of two classes, its pairings, a random port
    checkpoint, and a 'student' of it that carries distill metadata."""
    d = tmp_path_factory.mktemp("tiny")
    rng = np.random.RandomState(0)
    write_pack(d / "d.spk", rng.randint(0, 256, (16, 128, 130), np.uint8),
               np.arange(16, dtype=np.uint16) % 2, ["a", "b"])
    rows = [("a" if i % 2 else "b", i % 8, "b" if i % 2 else "a",
             (3 * i) % 8) for i in range(20)]
    (d / "pairs.csv").write_text(
        "".join(f"{a},{i},{b},{j}\n" for a, i, b, j in rows))
    ldm = build_ldm(device="cpu", seed=0)
    save_checkpoint(d / "ckpt.pt", ldm)
    save_checkpoint(d / "student.pt", ldm,
                    distill={"steps": 1, "t_max": 3, "stages": [1],
                             "guidance": 1.0})
    return d


def test_eval_transfer_end_to_end(tiny, tmp_path, capsys):
    out = tmp_path / "evals"
    assert torch_eval_transfer.main(
        ["--device", "cpu", "--checkpoint", str(tiny / "ckpt.pt"),
         "--pack", str(tiny / "d.spk"), "--pairings",
         str(tiny / "pairs.csv"), "--n-pairs", "2", "--steps", "2",
         "--out-dir", str(out), "--json-name",
         "transfer_eval_t2_ddim.json"]) == 0
    r = json.loads((out / "transfer_eval_t2_ddim.json").read_text())
    assert r["n_pairs"] == 2 and r["eval_backend"] == "cpu"
    assert np.isfinite(r["style_distance_reduction_pct"])
    assert set(r["vggish_multiseed_style_reduction_pct"]) == {"11", "29"}
    assert (out / "transfer_t2_ddim_panel.png").stat().st_size > 1000
    # the JAX package's summaries read the port's record unchanged
    capsys.readouterr()
    for tool in (summarize_evals, summarize_sweep):
        argv = sys.argv
        sys.argv = [tool.__name__, str(out)]
        try:
            assert tool.main() == 0
        finally:
            sys.argv = argv
    text = capsys.readouterr().out
    assert text.count(f"| {r['style_distance_reduction_pct']}") >= 1
    assert "| 2 | ddim |" in text or "t2" in text


def test_eval_generate_end_to_end(tiny, tmp_path):
    out = tmp_path / "gen.json"
    assert torch_eval_generate.main(
        ["--device", "cpu", "--checkpoint", str(tiny / "ckpt.pt"),
         "--pack", str(tiny / "d.spk"), "--style-class", "0", "--n", "2",
         "--steps", "2", "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    for k in ("fad_generated_vs_style_corpus", "fad_real_vs_real_floor",
              "fad_other_class_ceiling", "pairwise_spread_generated",
              "pairwise_spread_real"):
        assert np.isfinite(r[k]), k
    assert r["class_name"] == "a" and r["n"] == 2


def test_eval_distill_fidelity_end_to_end(tiny, tmp_path):
    """The student carries distill metadata, so it samples on kernel A's
    route (its plain version here); the teacher on the scan route."""
    out = tmp_path / "fid.json"
    assert torch_eval_distill_fidelity.main(
        ["--device", "cpu", "--teacher", str(tiny / "ckpt.pt"),
         "--student", str(tiny / "student.pt"), "--sample-steps", "2",
         "--pack", str(tiny / "d.spk"), "--pairings",
         str(tiny / "pairs.csv"), "--n-pairs", "2", "--steps", "3",
         "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    assert r["n_pairs"] == 2
    # same weights, same noise, the same DDIM grid: the fused route's
    # plain version and the scan route agree closely
    assert (r["student_distilled"]["mse_vs_teacher50"]
            == pytest.approx(r["teacher_coarse"]["mse_vs_teacher50"],
                             rel=1e-2, abs=1e-5))


# ---------------- the full-scale run -----------------------------------------


def test_fullscale_prepare_and_measure(tmp_path):
    torch_fullscale_run.prepare_dataset(tmp_path, seconds=6.0, pairs=12,
                                        device="cpu")
    assert (tmp_path / "train.spk").exists()
    assert len((tmp_path / "pairings.csv").read_text().splitlines()) == 12
    ds = PackedPairDataset(tmp_path / "train.spk", tmp_path / "pairings.csv")
    assert len(ds.pack) == 8          # 4 voices x two 3 s chunks
    loader = PackedBatchLoader(ds, 2, indices=np.arange(4), shuffle=False,
                               dtype="uint8")
    trainer = LDMTrainer(default_config(), device="cpu")
    meas = torch_fullscale_run.measure_pipeline(
        trainer, trainer.init_state(0), loader, n_steps=2, n_synced=2)
    assert meas["pipelined_steps"] == 2 and meas["synced_steps"] == 2
    assert 0.0 <= meas["loader_wait_frac"] < 1.0
    assert meas["sustained_samples_per_s"] > 0
    assert set(meas) == _keys(TOOLS / "fullscale_run.py", "result")
