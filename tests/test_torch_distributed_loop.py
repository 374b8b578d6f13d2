"""The port's data-parallel training loop across spawned processes (CPU).

Two ranks over gloo with a file store under ``tmp_path``: a run resumed
from a checkpoint draws what the uninterrupted run drew and ends in the
same state, and only rank 0 writes.  Then ``cli train`` under
``python -m torch.distributed.run --nproc-per-node 2`` against the
one-process command.  The steps themselves are held to the JAX package
in ``test_torch_distributed.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray

ROOT = Path(__file__).resolve().parents[1]

_WORKER = r'''
"""One rank: python worker.py RANK WORLD STORE SPEC OUT."""
import dataclasses
import sys

import torch

torch.set_num_threads(1)

from music_style_transfer_ldm_tpu_torch import parallel
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.datasets.loader import BatchLoader
from music_style_transfer_ldm_tpu_torch.training import LDMTrainer


def main():
    rank, world, store, spec_path, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    assert parallel.initialize(store, world, rank, device="cpu")
    spec = torch.load(spec_path, weights_only=False)
    cfg = default_config()
    cfg.train = dataclasses.replace(cfg.train, batch_size=4,
                                    compute_dtype="float32",
                                    style_dropout=0.5)
    cfg.model = dataclasses.replace(cfg.model, image_size=64)
    # every rank calls the savers (they gather split tensors); count the
    # files each rank writes
    saves, real_save = [], torch.save

    def counted(obj, path, *a, **k):
        if str(path).endswith(".pt"):
            saves.append(str(path))
        return real_save(obj, path, *a, **k)
    torch.save = counted

    def run(tag, **kw):
        tr = LDMTrainer(cfg, perceptual=False, device="cpu")
        seen, draws = [], tr.draws

        def spy(step, batch, *a):
            got = draws(step, batch, *a)
            seen.append(tuple(x.clone() for x in got))
            return got
        tr.draws = spy
        loader = BatchLoader(spec["pairs"], 4, shuffle=False, num_threads=1,
                             process_index=rank, process_count=world)
        state = tr.train(loader, out_dir=f"{spec['out_dir']}/{tag}", **kw)
        return state, seen

    full, d_full = run("full", num_epochs=2)
    _, d_first = run("first", num_epochs=1)
    rest, d_rest = run("rest", num_epochs=2,
                       resume_from=f"{spec['out_dir']}/first/ldm_0.pt")
    torch.save = real_save
    torch.save({"d_full": d_full, "d_split": d_first + d_rest,
                "full": full.model.state_dict(),
                "resumed": rest.model.state_dict(),
                "step": (full.step, rest.step), "saves": saves},
               f"{out}.{rank}")
    parallel.shutdown()


main()
'''


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_two_rank_run_resumes_exactly_and_only_rank_0_writes(tmp_path):
    """7 pairs in batches of 4 and 3 (rank 1 pads the second): two epochs
    in one run, and one epoch then a resumed one."""
    rng = np.random.RandomState(4)
    pairs = [((rng.rand(64, 64, 1).astype(np.float32), "a"),
              (rng.rand(64, 64, 1).astype(np.float32), "b"))
             for _ in range(7)]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    torch.save({"pairs": pairs, "out_dir": str(tmp_path)}, tmp_path / "spec")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2",
         f"file://{tmp_path / 'store'}", str(tmp_path / "spec"),
         str(tmp_path / "out")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(tmp_path / f"out.{r}", weights_only=False)
             for r in range(2)]
    for res in ranks:
        assert res["step"] == (4, 4)
        assert len(res["d_full"]) == len(res["d_split"]) == 4
        for step, (a, b) in enumerate(zip(res["d_full"], res["d_split"])):
            for x, y in zip(a, b):
                assert torch.equal(x, y), step
        for k, v in res["full"].items():
            assert torch.equal(v, res["resumed"][k]), k
    # the ranks hold their halves of one global batch's draws
    assert not torch.equal(ranks[0]["d_full"][0][1], ranks[1]["d_full"][0][1])
    # rank 0 writes every checkpoint (2 + 2 + 1), rank 1 none
    assert len(ranks[0]["saves"]) == 5 and ranks[1]["saves"] == []
    rows = (tmp_path / "full" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 3                           # header + two epochs


def _png_folder(root: Path) -> Path:
    rng = np.random.RandomState(5)
    for cls in ("classic", "rock"):
        (root / cls).mkdir(parents=True)
        for i in range(2):
            (root / cls / f"{i:03d}.png").write_bytes(write_png_gray(
                rng.randint(0, 256, (128, 128)).astype(np.uint8)))
    return root


def test_cli_train_under_torchrun_equals_one_process(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m ...cli
    train --device cpu`` at the default config (full width, 128x128, one
    global batch of 3 pairs: rank 1 holds a pad row) writes one
    checkpoint, equal to the one-process command's at 1e-5.  Adam moves a
    parameter whose true gradient is 0 (a conv bias feeding a train-mode
    BatchNorm) by up to its learning rate on rounding noise, so those two
    are held within twice the learning rate."""
    root = _png_folder(tmp_path / "img")
    pairs = tmp_path / "pairs.csv"
    assert cli.main(["generate-pairings", "--root", str(root), "--output",
                     str(pairs), "--num-pairs", "3"]) == 0
    args = ["train", "--model", "ldm", "--data-root", str(root),
            "--pairing-file", str(pairs), "--epochs", "1", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "music_style_transfer_ldm_tpu_torch.cli"] + args
        + ["--out-dir", str(tmp_path / "dp")], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("trained 1 steps per epoch") == 1
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert cli.main(args + ["--out-dir", str(tmp_path / "one")]) == 0
    finally:
        torch.set_num_threads(prev)
    got = torch.load(tmp_path / "dp" / "ldm_final.pt", weights_only=True)
    want = torch.load(tmp_path / "one" / "ldm_final.pt", weights_only=True)
    assert got["step"] == want["step"] == 1
    lr = default_config().train.learning_rate
    zero_grad = ("decoder.deconv1.bias", "decoder.deconv2.bias")
    for k, v in want["params"].items():
        tol = 2 * lr if k in zero_grad else 1e-5
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=tol, err_msg=k)
    assert sorted(p.name for p in (tmp_path / "dp").iterdir()) == sorted(
        p.name for p in (tmp_path / "one").iterdir())
