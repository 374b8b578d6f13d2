"""Framework configuration (copy of the JAX package's dataclasses).

The port keeps its own copy so it imports nothing of the JAX package.
``MeshConfig`` is the (data, model) layout of ``parallel/``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class AudioConfig:
    """DSP parameters."""

    sample_rate: int = 22050
    n_fft: int = 2048
    hop_length: int = 512
    win_length: int = 2048
    n_mels: int = 128
    fmin: float = 0.0
    fmax: float | None = None         # None -> sample_rate / 2
    max_db: float = 80.0
    top_db: float = 80.0
    trim_top_db: float = 20.0
    chunk_seconds: float = 3.0
    max_duration: float = 1800.0
    griffin_lim_iters: int = 32
    griffin_lim_momentum: float = 0.99
    nnls_iters: int = 64


@dataclasses.dataclass
class ModelConfig:
    """Model hyperparameters."""

    latent_dim: int = 32
    unet_num_filters: int = 64
    style_num_filters: int = 64
    time_emb_dim: int = 128
    attn_num_heads: int = 4
    image_size: int = 128             # 128x128 mel images
    in_channels: int = 1


@dataclasses.dataclass
class DiffusionConfig:
    """Noise schedule."""

    num_timesteps: int = 200
    beta_start: float = 1e-4
    beta_end: float = 0.02
    transfer_timesteps: int = 100


@dataclasses.dataclass
class TrainConfig:
    """Training hyperparameters."""

    learning_rate: float = 5e-4
    lr_factor: float = 0.5
    lr_patience: int = 5
    ldm_lr_patience: int = 10
    lr_min: float = 1e-6
    num_epochs: int = 202
    batch_size: int = 128
    style_loss_weight: float = 3.0
    perceptual_weight: float = 0.1
    kl_weight: float = 0.01
    compression_feature_extractor: str = "lpips"
    style_loss_stop_gradient: bool = True
    training_iteration_noise: int = 50
    style_dropout: float = 0.0
    ema_decay: float = 0.0
    train_split: float = 0.8
    seed: int = 0
    ckpt_every_epochs: int = 100
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


@dataclasses.dataclass
class DataConfig:
    """Paths."""

    data_dir: str = "downloads/"
    processed_dir: str = "processed_images"
    pairing_file: str = "spectrogram_pair_dataset_pairings.csv"
    num_pairs: int = 15000
    pairing_seed: int = 42
    pretrained_dir: str = "pretrained/"
    plots_dir: str = "plots/"


@dataclasses.dataclass
class MeshConfig:
    """The trainers' device mesh (``parallel/mesh.py``), the JAX
    package's fields.  ``mesh_shape`` (n, m): n data indices by a model
    axis of m over n x m ranks (one process each; -1 fills from the rank
    count).  At m > 1 the wide layers split over the model axis (tensor
    parallelism), or with ``sequence_parallel`` the LDM trainer's batches
    split on their width (sequence parallelism, for clips too wide for
    one card).  The port names its axes "data" and "model" and reads
    neither ``data_axis`` nor ``model_axis``."""

    data_axis: str = "data"
    model_axis: str = "model"
    mesh_shape: Tuple[int, int] = (-1, 1)
    sequence_parallel: bool = False


@dataclasses.dataclass
class Config:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = dataclasses.field(
        default_factory=DiffusionConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def default_config() -> Config:
    return Config()
