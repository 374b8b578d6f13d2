"""The port stands alone: no JAX, no flax, no JAX package, no triton
(every kernel is CUDA C++ built with nvcc); and its entry points refuse
to run on the CPU unless asked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "music_style_transfer_ldm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "music_style_transfer_ldm_tpu",
             "triton")
# The port's tools and demos, by name (tools/torch_wide_near_ties.py and
# tools/torch_ae_grad_spread.py compare against JAX on the CPU and stay
# out), each with the least argv its parser takes.
SCRIPTS = {
    "tools/torch_common.py": None,
    "tools/torch_serving_load_curve.py": [],
    "tools/torch_roofline_b64.py": [],
    "tools/torch_eval_transfer.py": ["--checkpoint", "c.pt", "--pack",
                                     "p.spk", "--pairings", "p.csv"],
    "tools/torch_eval_generate.py": ["--checkpoint", "c.pt", "--pack",
                                     "p.spk"],
    "tools/torch_eval_distill_fidelity.py": [
        "--teacher", "t.pt", "--student", "s.pt", "--sample-steps", "2",
        "--pack", "p.spk", "--pairings", "p.csv"],
    "tools/torch_fullscale_run.py": [],
    "tools/torch_riffusion_unet_times.py": [],
    "examples/torch_end_to_end_demo.py": [],
    "examples/torch_real_melody_demo.py": [],
}


def _sources():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + [ROOT / name for name in SCRIPTS])
    assert len(files) > 20
    return files


def _imports(tree):
    """The module name of every import in a module, at any depth."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_forbidden_imports():
    bad = []
    for path in _sources():
        for name in _imports(ast.parse(path.read_text())):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_package_import_leaves_jax_unloaded():
    code = ("import sys, importlib, pkgutil\n"
            "import music_style_transfer_ldm_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'triton', 'music_style_transfer_ldm_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_entry_points_need_the_card_unless_asked():
    from music_style_transfer_ldm_tpu_torch import cli
    from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
    from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device
    if torch.cuda.is_available():
        assert build_ldm().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_ldm()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    for argv in (["distill", "--checkpoint", "missing.pt"],
                 ["diagnose", "--checkpoint", "missing.pt"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert build_ldm(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("script", [k for k, v in SCRIPTS.items()
                                    if v is not None])
def test_tools_need_the_card_unless_asked(script, tmp_path, monkeypatch):
    """Each tool and demo refuses to start without a card unless given
    --device cpu, before it reads or writes anything."""
    import importlib
    sys.path.insert(0, str(ROOT))
    module = importlib.import_module(script[:-3].replace("/", "."))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(SCRIPTS[script])
    assert not any(tmp_path.iterdir())


def test_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card is refused, not
    sent to the plain version."""
    from music_style_transfer_ldm_tpu_torch.ops import fused_sampler as fs
    from music_style_transfer_ldm_tpu_torch.ops.ddim_update import (
        ddim_update_, fused_ddim_update, step_scalars,
    )
    from music_style_transfer_ldm_tpu_torch.ops.fused_mel_image import (
        fused_mel_unit_image,
    )
    x = torch.zeros(1, 16, 16, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_ddim_update(x, x, 0.5, 0.6)
    with pytest.raises(RuntimeError, match="no kernel"):
        ddim_update_(x, x, step_scalars(0.5, 0.6, 0.0))
    ops = fs.FusedOperands([], [], [], x, x, torch.float32, 1)
    with pytest.raises(RuntimeError, match="no kernel"):
        fs.fused_ddim_sample(ops, x, 1)
    fb = torch.zeros(128, 1025, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_mel_unit_image(fb, torch.zeros(1, 1025, 130, device="meta"))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
