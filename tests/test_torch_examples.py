"""The port's demos (``examples/torch_*.py``) and ``cli transfer`` on a
real (public-domain) melody, on the CPU: the port's counterpart of
``tests/test_examples.py``'s melodic product-path test."""

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from examples import (  # noqa: E402
    melodies, torch_end_to_end_demo, torch_real_melody_demo,
)
from music_style_transfer_ldm_tpu_torch.audio.io import (  # noqa: E402
    load_audio, write_wav,
)
from music_style_transfer_ldm_tpu_torch.cli import main  # noqa: E402
from music_style_transfer_ldm_tpu_torch.models.ldm import (  # noqa: E402
    build_ldm,
)
from music_style_transfer_ldm_tpu_torch.training import (  # noqa: E402
    checkpoint,
)

# the JAX package's committed artifacts: no port default may write there
PROTECTED = (REPO / "examples" / "demo_output", REPO / "docs" / "results")


def test_cli_transfer_on_real_melody(tmp_path, monkeypatch):
    """Violin Twinkle -> a piano-voice style, fused sampler (kernel A's
    plain version on the CPU) with --match-level, 8 steps."""
    monkeypatch.chdir(tmp_path)
    checkpoint.save_checkpoint(tmp_path / "ckpt.pt", build_ldm(device="cpu"))
    # twinkle at 120 bpm is one 7 s pass: 3 chunks after padding
    write_wav(tmp_path / "content.wav",
              melodies.render_melody("twinkle", "violin",
                                     min_seconds=4.0), 22050)
    write_wav(tmp_path / "style.wav",
              melodies.render_melody("greensleeves", "piano",
                                     min_seconds=3.0), 22050)
    assert main(["transfer", "--checkpoint", str(tmp_path / "ckpt.pt"),
                 "--content", str(tmp_path / "content.wav"),
                 "--style", str(tmp_path / "style.wav"),
                 "--sampler", "fused", "--steps", "8", "--match-level",
                 "--output", str(tmp_path / "out"), "--device", "cpu"]) == 0
    y, sr = load_audio(tmp_path / "out.wav")
    assert sr == 22050 and np.isfinite(y).all()
    # whole 3 s chunks out, at least two of them
    assert len(y) % (3 * sr) == 0 and len(y) >= 2 * 3 * sr
    assert (tmp_path / "out.png").stat().st_size > 1000


@pytest.mark.parametrize("demo,flags", [
    (torch_end_to_end_demo, ("workdir",)),
    (torch_real_melody_demo, ("workdir", "out"))])
def test_demo_defaults_stay_off_the_committed_artifacts(demo, flags):
    args = demo.build_parser().parse_args([])
    assert args.device == "cuda"
    for flag in flags:
        path = Path(getattr(args, flag)).resolve()
        for protected in PROTECTED:
            assert protected != path and protected not in path.parents, (
                flag, path)
