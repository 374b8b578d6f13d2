"""Riffusion v1 (riffusion/riffusion-model-v1): Stable Diffusion 1.5
fine-tuned on 512x512 mel spectrograms, and its SDEdit product path.

``Riffusion`` holds the CLIP text encoder, the UNet and the KL VAE
(``models/clip_text.py``, ``sd_unet.py``, ``vae_kl.py``) with a
``scaled_linear`` schedule of 1,000 steps.  A request's condition is a
prompt as token ids (``clip_text.prompt_ids``: [77] int64); the
unconditional branch of classifier-free guidance reads the empty
prompt's text states, computed once and kept (``uncond_states``, again
after ``refresh_uncond``).

``riffusion_transfer`` is ``models/ldm.py transfer_decoded``'s contract
for this model: the grey content image in [0, 1] goes in on three
channels at [-1, 1], the VAE's latent mean (times 0.18215) is noised to
t = N - 1 with the request's own draw, the scan DDIM (kernel B on the
card) walks ``transfer_time_grid(N, steps)`` with both branches as one
2B UNet call a step (``ldm._denoise_fn``), and the decoded RGB's mean is
the output image.  ``riffusion_generate`` starts from noise instead.  ``Riffusion`` is its
own serving route (``serving/engine.py ServingRoute``): a request's style
is its prompt's token ids.
Spans: ``riffusion.text``, ``ldm.encode``, ``ldm.sample`` and
``ldm.decode``, each with its device interval; counters ``unet.calls``
and ``unet.rows``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.audio import riffusion as _audio
from music_style_transfer_ldm_tpu_torch.config import (
    AudioConfig, RiffusionConfig, riffusion_audio_config,
)
from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (
    generation_time_grid, transfer_time_grid,
)
from music_style_transfer_ldm_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
)
from music_style_transfer_ldm_tpu_torch.models.clip_text import (
    CLIPTextEncoder, prompt_ids,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import (
    _run_sampler, guided_rows, per_item_noise, seeded_noise,
)
from music_style_transfer_ldm_tpu_torch.models.sd_unet import SDUNet
from music_style_transfer_ldm_tpu_torch.models.vae_kl import AutoencoderKL
from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device
from music_style_transfer_ldm_tpu_torch.utils.profiling import count, span


class Riffusion(nn.Module):
    """The composite, and its serving route."""

    def __init__(self, config: RiffusionConfig = RiffusionConfig(),
                 audio: Optional[AudioConfig] = None):
        super().__init__()
        self.config = config
        self.text_encoder = CLIPTextEncoder(config.text)
        self.unet = SDUNet(config.unet)
        self.vae = AutoencoderKL(config.vae)
        self.audio_config = audio or riffusion_audio_config()
        self.num_timesteps = config.num_timesteps
        self.latent_dim = config.vae.latent_channels
        self.image_size = config.image_size
        # the VAE halves the side at each level but its last
        self.latent_size = config.image_size >> (
            len(config.vae.block_out_channels) - 1)
        self._schedule: Optional[DiffusionSchedule] = None
        self._uncond: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype

    @property
    def schedule(self) -> DiffusionSchedule:
        if (self._schedule is None
                or self._schedule.alpha_bars.device != self.device):
            c = self.config
            self._schedule = DiffusionSchedule(
                c.num_timesteps, c.beta_start, c.beta_end, self.device,
                kind=c.beta_schedule)
        return self._schedule

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        """[B, 77] token ids -> text states [B, 77, width], model type."""
        with span("riffusion.text", device=self.device):
            return self.text_encoder(ids.to(self.device))

    def refresh_uncond(self) -> torch.Tensor:
        """Encode the empty prompt again and keep its states."""
        ids = torch.as_tensor(prompt_ids([], self.config.text)[None],
                              device=self.device)
        self._uncond = self.encode_text(ids)
        return self._uncond

    def uncond_states(self) -> torch.Tensor:
        """The empty prompt's text states [1, 77, width], kept."""
        u = self._uncond
        if u is None or u.device != self.device or u.dtype != self.dtype:
            u = self.refresh_uncond()
        return u

    def condition(self, prompts) -> torch.Tensor:
        """[B, 77] token ids (as ``prompt_ids`` builds them) on the
        model's device."""
        return torch.as_tensor(np.asarray(prompts, np.int64),
                               device=self.device)

    # ------------- the serving route (serving/engine.py) -------------

    def audio_processor(self, a: AudioConfig, nnls_iters: int, device):
        return _audio.FrontEnd(a, device)

    def warm_condition(self, x: torch.Tensor) -> torch.Tensor:
        ids = prompt_ids([], self.config.text)
        return self.condition(np.repeat(ids[None], x.shape[0], 0))

    def transfer(self, content, cond, seeds, cfg, fused: bool):
        if fused:
            raise ValueError("Riffusion runs a scan sampler (ddim, dpm++)")
        decoded = riffusion_transfer(
            self, content, cond, num_timesteps=cfg.steps,
            steps=cfg.sample_steps, guidance=cfg.guidance, eta=cfg.eta,
            sampler=cfg.sampler, seeds=seeds)
        b = content.shape[0]
        times = transfer_time_grid(cfg.steps, cfg.sample_steps)
        return decoded, {"guided_rows": guided_rows(b, times, cfg.guidance),
                         "prompts_encoded": b}

    def generate(self, cond, seed, cfg):
        """From noise over ``generate_steps`` grid points, else the
        transfer's ``sample_steps``."""
        steps = (cfg.generate_steps if cfg.generate_steps is not None
                 else cfg.sample_steps or cfg.steps)
        decoded = riffusion_generate(
            self, cond, steps=steps, guidance=cfg.generate_guidance,
            eta=cfg.eta, sampler=cfg.sampler, seed=seed)
        b = cond.shape[0]
        times = generation_time_grid(self.num_timesteps, steps)
        return decoded, {
            "guided_rows": guided_rows(b, times, cfg.generate_guidance),
            "prompts_encoded": b}

    def invert(self, images, a, n_iter, nnls_iters):
        return _audio.image_to_audio(images[:, :, :, 0], a, n_iter=n_iter,
                                     nnls_iters=nnls_iters)

    def read_style(self, req, decode):
        """The request's ``prompt_ids`` (absent: the empty prompt)."""
        return prompt_ids(req.get("prompt_ids", []), self.config.text)

    def wav_audio(self, audio):
        return _audio.peak_normalize(audio)

    def noised_latents(self, content: torch.Tensor, num_timesteps: int,
                       seeds=0) -> torch.Tensor:
        """NHWC grey content [B, S, S, 1] in [0, 1] -> its scaled latent
        mean noised to t = num_timesteps - 1, f32 NCHW; each item's draw
        [S/8, S/8, 4] (NHWC) from a generator seeded by its seed."""
        if num_timesteps > self.num_timesteps:
            raise ValueError(f"num_timesteps={num_timesteps} exceeds the "
                             f"schedule length T={self.num_timesteps}")
        x = content.to(self.device, torch.float32).permute(0, 3, 1, 2)
        z0 = self.vae.encode_mean(2.0 * x.expand(-1, 3, -1, -1) - 1.0)
        z0 = z0.float().contiguous()
        B, C, h, w = z0.shape
        eps = per_item_noise(seeds, B, (h, w, C), self.device).permute(
            0, 3, 1, 2)
        t = torch.full((B,), num_timesteps - 1, dtype=torch.long,
                       device=self.device)
        return self.schedule.q_sample_with_noise(z0, t, eps)

    def decode_unit(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, 4, h, w] -> NHWC grey images [B, 8h, 8w, 1]
        in [0, 1]: the decoded RGB mapped to [0, 1], clipped, averaged."""
        rgb = self.vae.decode(z).float()
        return ((rgb + 1.0) / 2.0).clamp(0.0, 1.0).mean(1)[..., None]


def _sample(model: Riffusion, z: torch.Tensor, ids: torch.Tensor,
            times: np.ndarray, guidance: float, eta: float,
            sampler: str) -> torch.Tensor:
    text = model.encode_text(ids)
    uncond = None
    if guidance != 1.0:
        uncond = model.uncond_states().expand(z.shape[0], -1, -1)
    calls = len(times) - 1
    count("unet.calls", calls)
    count("unet.rows", calls * z.shape[0] * (1 if uncond is None else 2))
    with span("ldm.sample", device=model.device):
        return _run_sampler(sampler, model, text, guidance, z, times, eta,
                            uncond=uncond)


@torch.no_grad()
def riffusion_transfer(model: Riffusion, content: torch.Tensor,
                       ids: torch.Tensor, num_timesteps: int = 750,
                       steps: Optional[int] = 38, guidance: float = 7.0,
                       eta: float = 0.0, sampler: str = "ddim",
                       seeds=0) -> torch.Tensor:
    """SDEdit of NHWC grey content [B, S, S, 1] under prompts ``ids``
    [B, 77] -> NHWC grey images in [0, 1], f32."""
    dev = model.device
    with span("ldm.encode", device=dev):
        z_t = model.noised_latents(content, num_timesteps, seeds)
    z = _sample(model, z_t, ids, transfer_time_grid(num_timesteps, steps),
                guidance, eta, sampler)
    with span("ldm.decode", device=dev):
        return model.decode_unit(z)


@torch.no_grad()
def riffusion_generate(model: Riffusion, ids: torch.Tensor, steps: int = 38,
                       guidance: float = 7.0, eta: float = 0.0,
                       sampler: str = "ddim", seed: int = 0) -> torch.Tensor:
    """Text-to-spectrogram from noise (one generator seeded by ``seed``)
    over ``generation_time_grid(T, steps)`` -> NHWC grey images."""
    dev = model.device
    h = model.latent_size
    noise = seeded_noise((ids.shape[0], h, h, model.latent_dim), seed, dev)
    z = _sample(model, noise.permute(0, 3, 1, 2).contiguous(), ids,
                generation_time_grid(model.num_timesteps, steps), guidance,
                eta, sampler)
    with span("ldm.decode", device=dev):
        return model.decode_unit(z)


def load_riffusion(checkpoint: Optional[str] = None,
                   config: Optional[RiffusionConfig] = None,
                   dtype=torch.bfloat16, device="cuda") -> Riffusion:
    """A Riffusion in eval mode on ``device``, channels-last: from
    ``checkpoint`` (a ``torch.save`` of {"text_encoder", "unet", "vae"}
    state dicts under diffusers' and transformers' names, loaded
    strictly), or, without one, ``build_riffusion``'s seeded weights."""
    if checkpoint is None:
        return build_riffusion(config, dtype, device)
    device = resolve_device(device)
    payload = torch.load(checkpoint, map_location="cpu", weights_only=True)
    with torch.device("meta"):
        model = Riffusion(config or RiffusionConfig())
    for part in ("text_encoder", "unet", "vae"):
        getattr(model, part).load_state_dict(payload[part], assign=True)
    model.requires_grad_(False)
    return model.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last).eval()


def build_riffusion(config: Optional[RiffusionConfig] = None,
                    dtype=torch.bfloat16, device="cuda",
                    seed: int = 0) -> Riffusion:
    """A Riffusion with weights from ``seed`` (PyTorch's default init; no
    public checkpoint is in the repository) in eval mode on ``device``,
    channels-last."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Riffusion(config or RiffusionConfig())
    model.requires_grad_(False)
    return model.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last).eval()
