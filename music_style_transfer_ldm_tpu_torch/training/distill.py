"""Progressive distillation of the transfer sampler.

Salimans & Ho, "Progressive Distillation for Fast Sampling of Diffusion
Models" (ICLR 2022): a student of the same architecture learns to make
ONE DDIM step where its teacher makes ``factor`` (2: halving), on
aligned grids, so a cascade 96 -> 48 -> 24 -> 12 -> 6 ends with a
transfer of 6 denoiser calls instead of 99.  A distilled student is a
regular checkpoint of the port (``training/checkpoint.py``) with a
``distill`` dict ({"steps", "t_max", "stages", "guidance"}), sampled by
the stock samplers at ``steps=N + 1`` over ``t_max``: the grid
``transfer_time_grid`` gives there is the one the student trained on
(``distill_stage_grids`` checks that identity).

One stage step (the JAX package's ``_stage_step_fn``):

* each sample draws its student segment i and the q-sample noise from a
  generator seeded by (seed, stage, step), so a resumed stage draws what
  the uninterrupted stage drew; both draws can be given instead;
* the frozen encoder and style encoder (running BatchNorm statistics)
  give z_0 and the style pyramid; z_t = sqrt(ab_t) z_0 + sqrt(1-ab_t) eps;
* the teacher, a frozen deep copy of the stage-entry weights that never
  shares storage with the student, walks ``factor`` DDIM steps t -> s
  without a gradient; with ``guidance`` != 1 (first stage only) each of
  its eps is the classifier-free combination of one doubled-batch UNet
  call (``models/ldm.py _denoise_fn``'s [cond; uncond] layout);
* ``solve_x0_target`` inverts one DDIM step t -> s onto the teacher's
  end point, and the student's x0 is held to it by the truncated-SNR-
  weighted MSE (max(ab_t / (1 - ab_t), 1)), summed over the real rows
  and divided by their count (pad rows weigh 0: the JAX step's ``w``);
* a fresh Adam per stage over the UNet's parameters only: encoder,
  decoder and style encoder stay bit-identical.

On the card the UNet calls run under bf16 autocast when
``TrainConfig.compute_dtype`` is bfloat16 and each eps is cast to f32;
the target algebra runs in f32 outside autocast (its denominator
sqrt(ab_s) - c sqrt(ab_t) is small at low noise).  On the CPU
everything is f32.

Data parallelism (``parallel/``): under a process group each rank takes
its slice of every global batch.  The draws are made for the whole padded
global batch from (seed, stage, step) and each rank keeps its rows; a
rank's loss is world x (its weighted sum) / max(global sum of weights,
1), and the UNet runs in DistributedDataParallel (as the trainers'
modules do), whose gradient mean over the ranks is then the gradient of
the global loss, so a step equals the one-process step on the global
batch.  Rank 0 alone writes the in-flight saves and the students, with a
barrier after each.

On an (n, m) mesh the student is split over the model axis (tensor
parallelism of its UNet, the JAX package's ``shard_params`` of the
student; ``parallel/sharding.py``), rows and draws are keyed by the
data index, and each stage's teacher is whole on every rank
(``gather_params`` of its copy).  The saves hold the whole tensors.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (
    transfer_time_grid,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import LDM, _denoise_fn
from music_style_transfer_ldm_tpu_torch.parallel.collectives import (
    DataParallel, all_reduce_mean, all_reduce_sum, barrier, is_main,
    model_axis,
)
from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
    gather_params, local_blocks, shard_params, split_dims, step_rows,
    sync_replicated, training_mesh,
)
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt_lib
from music_style_transfer_ldm_tpu_torch.training.metrics import MetricLogger
from music_style_transfer_ldm_tpu_torch.training.optim import make_optimizer
from music_style_transfer_ldm_tpu_torch.training.state import (
    TrainState, as_unit_images, prefetch_to_device,
)
from music_style_transfer_ldm_tpu_torch.training.train_ldm import step_seed


def ddim_step(z_t: torch.Tensor, eps_hat: torch.Tensor, ab_t: torch.Tensor,
              ab_s: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM update (eta=0) with per-sample alpha-bars
    broadcastable to z_t (e.g. [B, 1, 1, 1]); the update rule of
    ``diffusion/ddim.py``."""
    x0_hat = (z_t - torch.sqrt(1.0 - ab_t) * eps_hat) / torch.sqrt(ab_t)
    return torch.sqrt(ab_s) * x0_hat + torch.sqrt(1.0 - ab_s) * eps_hat


def solve_x0_target(z_t: torch.Tensor, z_ss: torch.Tensor,
                    ab_t: torch.Tensor, ab_s: torch.Tensor) -> torch.Tensor:
    """The x0 that makes one DDIM step t -> s land on z_ss:

        x0 = (z_ss - c z_t) / (sqrt(ab_s) - c sqrt(ab_t)),
        c  = sqrt((1 - ab_s) / (1 - ab_t)),

    whose denominator is positive for s < t (ab_s > ab_t, c < 1)."""
    c = torch.sqrt((1.0 - ab_s) / (1.0 - ab_t))
    return (z_ss - c * z_t) / (torch.sqrt(ab_s) - c * torch.sqrt(ab_t))


def distill_stage_grids(t_max: int, n_teacher_steps: int, factor: int = 2
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(teacher_grid, student_grid) of one stage.

    The teacher grid is ``transfer_time_grid(t_max, n + 1)``; the student
    grid is every ``factor``-th point of it, which must equal
    ``transfer_time_grid(t_max, n // factor + 1)``, the grid a stock
    sampler walks at ``steps=n // factor + 1`` (a ValueError otherwise).
    factor 2 halves; a final stage may collapse an odd count to one step
    (factor = the whole count, e.g. 3 -> 1)."""
    factor = int(factor)
    if factor < 2:
        raise ValueError(f"factor must be >= 2, got {factor}")
    if n_teacher_steps % factor:
        raise ValueError(
            f"teacher steps must be divisible by the stage factor, got "
            f"{n_teacher_steps} % {factor}")
    teacher = transfer_time_grid(t_max, n_teacher_steps + 1)
    student = teacher[::factor]
    expected = transfer_time_grid(t_max, n_teacher_steps // factor + 1)
    if not np.array_equal(student, expected):
        raise ValueError(
            f"student grid {student} != stock sampler grid {expected} for "
            f"t_max={t_max}, teacher={n_teacher_steps}, factor={factor}")
    return teacher, student


def student_steps(stages: Sequence[int]) -> list:
    """The student step count of each stage: the next stage's teacher
    count, and for the last stage half its count, or 1 when it is odd."""
    students = []
    for k, n in enumerate(stages):
        s = (stages[k + 1] if k + 1 < len(stages)
             else (n // 2 if n % 2 == 0 else 1))
        if s < 1 or n % s or n // s < 2:
            raise ValueError(
                f"stage {k}: student steps {s} must divide teacher "
                f"steps {n} with an integer factor >= 2")
        students.append(s)
    return students


@dataclasses.dataclass
class Stage:
    """One stage: ``n_teacher`` teacher steps into ``n_student`` student
    steps on ``teacher_grid``, the frozen ``teacher`` and the student's
    fresh ``optimizer``."""

    index: int
    n_teacher: int
    n_student: int
    guidance: float
    teacher_grid: np.ndarray
    teacher: LDM
    optimizer: torch.optim.Optimizer

    @property
    def factor(self) -> int:
        return self.n_teacher // self.n_student


def _save_inflight(path: Path, student: LDM, optimizer, meta: dict,
                   mesh=None) -> None:
    """Write the live stage (a train-state checkpoint with the stage's
    identity in ``extra``) aside, then rename it into place: a crash
    mid-write leaves the previous save (or none), never half a file.
    With ``mesh``, every rank calls it and rank 0 writes."""
    tmp = path.with_name(path.name + ".tmp")
    ckpt_lib.save_train_state(tmp, TrainState(student, optimizer,
                                              meta["done"]), extra=meta,
                              mesh=mesh)
    if mesh is None or is_main(mesh):
        os.replace(tmp, path)


class ProgressiveDistiller:
    """Halve the transfer grid stage by stage, on one card or one card
    per rank (``mesh`` as in ``LDMTrainer``).

    Consumes the pair loader's ((content, _), (style, _)) batches, as
    ``training/train_ldm.py`` does."""

    def __init__(self, config, mesh=None, t_max: Optional[int] = None,
                 device="cuda"):
        self.config = config
        self.mesh = training_mesh(config.mesh, mesh, device)
        self.device = self.mesh.device
        self.compute_dtype = (getattr(torch, config.train.compute_dtype)
                              if self.device.type == "cuda"
                              else torch.float32)
        # Transfer walks the first `transfer_timesteps` of the schedule;
        # distill over that same range.
        self.t_max = int(t_max if t_max is not None
                         else config.diffusion.transfer_timesteps)
        self.generator = torch.Generator(device=self.device)
        self.ax = model_axis(self.mesh)   # tensor parallel; None at m = 1
        # the student's UNet as a step runs it: DistributedDataParallel
        # under a process group
        self.train_model = DataParallel(self.mesh)

    def _autocast(self):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    # ---------------- one stage step ---------------------------------------

    def start_stage(self, student: LDM, index: int, n_teacher: int,
                    n_student: int, lr: float, guidance: float = 1.0
                    ) -> Stage:
        """A stage from the student's current weights: its grid, the
        teacher (a deep copy of the student, sharing no storage with it,
        taking no gradient and whole on every rank) and a fresh Adam over
        the student's UNet."""
        teacher_grid, _ = distill_stage_grids(self.t_max, n_teacher,
                                              n_teacher // n_student)
        teacher = gather_params(copy.deepcopy(student), self.mesh)
        teacher = teacher.eval().requires_grad_(False)
        return Stage(index, n_teacher, n_student, guidance, teacher_grid,
                     teacher,
                     make_optimizer("adam", list(student.unet.parameters()),
                                    learning_rate=lr))

    def step(self, student: LDM, stage: Stage, content: torch.Tensor,
             style: torch.Tensor, seed: int, step: int,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step of ``stage`` on this rank's rows (``weights``
        their validity, None when none is padded), with the draws of
        (seed, stage, step); returns the global loss, on the device."""
        segment, noise = self.draws(
            seed, stage.index, step, content.shape[0], stage.n_student,
            (content.shape[1] // 8, content.shape[2] // 8,
             self.config.model.latent_dim))
        denominator = None
        if self.mesh.distributed and weights is not None:
            total = all_reduce_sum(weights.float().sum(),
                                   self.mesh.data_group)
            denominator = (torch.clamp(total, min=1.0)
                           / self.mesh.data_size)
        stage.optimizer.zero_grad(set_to_none=True)
        loss = self.stage_loss(student, stage.teacher, stage.teacher_grid,
                               stage.factor, stage.guidance, content, style,
                               segment, noise, weights, denominator)
        loss.backward()
        sync_replicated(student, self.ax)
        stage.optimizer.step()
        return all_reduce_mean(loss.detach(), self.mesh)

    def draws(self, seed: int, stage: int, step: int, batch: int,
              n_student: int, latent_shape: Sequence[int]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(segment [B] in [0, n_student), NHWC noise [B, *latent_shape])
        of one step for this data index's ``batch`` rows, from a generator
        seeded by (seed, stage, step) (the counterpart of the JAX
        package's fold_in of stage * 1e6 + step into its base key): drawn
        for rows 0 .. max(configured batch, padded global batch) - 1
        (row i of a global batch takes draw i), this data index's rows
        kept.  ``latent_shape`` is the batch's latent (H / 8, W / 8,
        latent_dim)."""
        gen, mesh = self.generator, self.mesh
        n = max(self.config.train.batch_size, batch * mesh.data_size)
        rows = slice(mesh.data_index * batch, (mesh.data_index + 1) * batch)
        gen.manual_seed(step_seed(seed + 777, stage * 1_000_000 + step))
        segment = torch.randint(0, n_student, (n,), device=self.device,
                                generator=gen)
        noise = torch.randn((n, *latent_shape), device=self.device,
                            generator=gen)
        return segment[rows], noise[rows]

    def stage_loss(self, student: LDM, teacher: LDM,
                   teacher_grid: np.ndarray, factor: int, guidance: float,
                   content: torch.Tensor, style: torch.Tensor,
                   segment: torch.Tensor, noise: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   denominator: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """The student's loss on one batch (NHWC images in [0, 1] or
        uint8, segment [B], NHWC noise), with the graph to its UNet: the
        weighted sum over the rows (``weights`` [B] validity, default
        ones) divided by ``denominator``, by default max(sum of weights,
        1) (the batch size without weights)."""
        dev = self.device
        content = as_unit_images(content).float().permute(0, 3, 1, 2)
        style = as_unit_images(style).float().permute(0, 3, 1, 2)
        batch = content.shape[0]
        grid = torch.as_tensor(np.asarray(teacher_grid), dtype=torch.long,
                               device=dev)
        first = factor * segment.to(dev).long()
        t, s = grid[first], grid[first + factor]
        ab = student.schedule.alpha_bars

        def ab4(tt):
            return ab[tt].reshape(-1, 1, 1, 1)

        with torch.no_grad():
            with self._autocast():
                z0 = teacher.encoder(content.to(dev)).float()
                emb = teacher.style_encoder(style.to(dev))
            eps = noise.to(device=dev, dtype=torch.float32).permute(
                0, 3, 1, 2)
            z_t = torch.sqrt(ab4(t)) * z0 + torch.sqrt(1.0 - ab4(t)) * eps
            teacher_eps = _denoise_fn(teacher, emb, guidance)
            z_ss = z_t
            for j in range(factor):
                tj, tn = grid[first + j], grid[first + j + 1]
                with self._autocast():
                    eps_t = teacher_eps(z_ss, tj)
                z_ss = ddim_step(z_ss, eps_t.float(), ab4(tj), ab4(tn))
            x0_target = solve_x0_target(z_t, z_ss, ab4(t), ab4(s))
            # Truncated-SNR weighting (Salimans-Ho eq. 9), per sample.
            ab_t = ab[t]
            w_snr = torch.clamp(ab_t / (1.0 - ab_t), min=1.0)
            if weights is not None:
                w_snr = w_snr * weights.to(dev).float()
        if denominator is None:
            denominator = (batch if weights is None
                           else torch.clamp(weights.float().sum(), min=1.0))
        with self._autocast():
            eps_s = self.train_model(student.unet)(z_t, t, emb, self.ax)
        x0_s = ((z_t - torch.sqrt(1.0 - ab4(t)) * eps_s.float())
                / torch.sqrt(ab4(t)))
        per = torch.mean(torch.square(x0_s - x0_target), dim=(1, 2, 3))
        return torch.sum(w_snr * per) / denominator

    # ---------------- the cascade ------------------------------------------

    def distill(self, model: LDM, train_loader,
                stages: Sequence[int] = (96, 48, 24, 12, 6),
                steps_per_stage: int = 400, lr: float = 1e-4,
                out_dir: str | Path = "runs/distill", seed: int = 0,
                guidance: float = 1.0,
                inflight_every: int = 200) -> Tuple[LDM, dict]:
        """Run the cascade from the converged teacher ``model`` (left as
        it is; the student is a float32 copy on the distiller's device).

        stages: teacher step counts; stage k's student has stages[k+1]
        steps, the last stage's half its count or, when that count is
        odd, one step (e.g. (48, 24, 12, 6, 3) ends at one denoiser
        call).  Each stage writes ``out_dir/distilled_<n>.pt``.
        guidance != 1 distills a classifier-free-guided teacher in the
        first stage (it needs a style_dropout-trained checkpoint); later
        stages' teachers are already guidance-baked students, unguided.

        inflight_every > 0 also saves the live stage (student with its
        BatchNorm statistics, Adam state, step) every that many steps to
        ``out_dir/inflight_<n>to<m>.pt``; a rerun of the same cascade
        resumes the interrupted stage there (draws continue exactly; the
        loader's order does not).  The save is removed when its stage
        lands.

        Returns (student, info) with info {"steps", "t_max", "stages",
        "guidance", "history": [{teacher_steps, student_steps, loss_head,
        loss_tail}]}; the student is whole on every rank."""
        stages = [int(n) for n in stages]
        students = student_steps(stages)
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        dev, mesh = self.device, self.mesh
        main = is_main(mesh)
        logger = (MetricLogger(out_dir / "distill_metrics.csv") if main
                  else None)
        student = shard_params(copy.deepcopy(model).to(
            device=dev, dtype=torch.float32), mesh)
        student.requires_grad_(False)
        student.unet.requires_grad_(True)
        history = []

        def place(item):
            i, ((content, _), (style, _)) = item
            (content, style), w = step_rows((content, style), mesh,
                                            train_loader, i)
            return content, style, w

        for stage_idx, n_teacher in enumerate(stages):
            n_student = students[stage_idx]
            stage = self.start_stage(student, stage_idx, n_teacher,
                                     n_student, lr,
                                     guidance if stage_idx == 0 else 1.0)
            done, losses, t0 = 0, [], time.time()
            head_override = None
            inflight = out_dir / f"inflight_{n_teacher}to{n_student}.pt"
            if inflight_every and inflight.exists():
                try:
                    meta = ckpt_lib.load_checkpoint(inflight)["extra"]
                    if (int(meta["teacher_steps"]) == n_teacher
                            and int(meta["student_steps"]) == n_student):
                        done = ckpt_lib.restore_train_state(
                            inflight, TrainState(student, stage.optimizer),
                            mesh).step
                        head_override = (float(meta["head"])
                                         if done >= 20 else None)
                        if main:
                            print(f"  distill {n_teacher}->{n_student}: "
                                  f"resumed in-flight at step {done}/"
                                  f"{steps_per_stage}", flush=True)
                except ckpt_lib.LOAD_ERRORS + (KeyError,) as e:
                    print(f"  distill: in-flight restore failed "
                          f"({e!r}); restarting stage", flush=True)
                    student.load_state_dict(local_blocks(
                        stage.teacher.state_dict(), split_dims(student),
                        mesh))
                    stage = self.start_stage(student, stage_idx, n_teacher,
                                             n_student, lr, stage.guidance)
                    done = 0

            while done < steps_per_stage:
                made_progress = False
                for content, style, w in prefetch_to_device(
                        enumerate(train_loader), place):
                    made_progress = True
                    losses.append(self.step(student, stage, content, style,
                                            seed, done, w))
                    done += 1
                    if main and (done % 100 == 0
                                 or done == steps_per_stage):
                        print(f"  distill {n_teacher}->{n_student} step "
                              f"{done}/{steps_per_stage} "
                              f"loss {float(losses[-1]):.5f} "
                              f"({done / (time.time() - t0):.2f} steps/s)",
                              flush=True)
                    if (inflight_every and done % inflight_every == 0
                            and done < steps_per_stage):
                        head = (head_override if head_override is not None
                                else float(torch.stack(losses[:20]).mean())
                                if len(losses) >= 20 else 0.0)
                        _save_inflight(inflight, student,
                                       stage.optimizer, {
                                           "done": done,
                                           "teacher_steps": n_teacher,
                                           "student_steps": n_student,
                                           "head": head}, mesh)
                        barrier(mesh)
                    if done >= steps_per_stage:
                        break
                if not made_progress:
                    # An exhausted one-shot iterator would spin here
                    # forever: every pass yields nothing.
                    raise RuntimeError(
                        f"train_loader yielded no batches in a full pass "
                        f"({done}/{steps_per_stage} steps into stage "
                        f"{n_teacher}->{n_student}); distillation needs a "
                        f"re-iterable loader (e.g. BatchLoader), not an "
                        f"exhausted one-shot iterator")

            losses = torch.stack(losses).tolist() if losses else []
            # On an in-flight resume this run's first losses are mid-stage
            # values; the stage-entry head travels in the in-flight meta.
            head = (head_override if head_override is not None
                    else float(np.mean(losses[:20])) if losses else 0.0)
            tail = float(np.mean(losses[-20:])) if losses else head
            history.append({"teacher_steps": n_teacher,
                            "student_steps": n_student,
                            "loss_head": head, "loss_tail": tail})
            ckpt_lib.save_checkpoint(
                out_dir / f"distilled_{n_student}.pt", student,
                distill={"steps": n_student, "t_max": self.t_max,
                         "stages": stages[:stage_idx + 1],
                         "guidance": guidance}, mesh=mesh)
            if main:
                logger.log(epoch=stage_idx, teacher_steps=n_teacher,
                           student_steps=n_student, steps=done,
                           loss_head=head, loss_tail=tail,
                           seconds=time.time() - t0)
                if inflight.exists():   # the stage landed; drop the save
                    inflight.unlink()
            barrier(mesh)

        gather_params(student, mesh)
        info = {"steps": students[-1], "t_max": self.t_max,
                "stages": stages, "guidance": guidance, "history": history}
        return student.requires_grad_(False), info
