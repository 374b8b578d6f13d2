"""Hugging Face as another audio source: log in with ``HF_TOKEN`` (from
the environment or ``.env.local``), stream the free-music-archive-small
dataset, and keep the samples whose only genre tag is the one asked for.

Needs the optional ``huggingface_hub`` and ``datasets`` packages (and the
network); each is imported only when its step runs, with a clear error
where it is missing.
"""

from __future__ import annotations

from typing import Iterable, Optional

from music_style_transfer_ldm_tpu_torch.utils.env import get_env


def _require(module: str):
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise RuntimeError(f"{module} is not installed; the Hugging Face "
                           "source needs it (and the network)") from e


def authenticate(env_file: str = ".env.local") -> None:
    """Log in with HF_TOKEN."""
    token = get_env("HF_TOKEN", env_file=env_file)
    if not token:
        raise RuntimeError("HF_TOKEN not set (expected in .env.local)")
    _require("huggingface_hub").login(token=token)


def download_hf_dataset(name: str = "benjamin-paine/free-music-archive-small",
                        split: str = "train", streaming: bool = True):
    """The dataset, streamed by default."""
    return _require("datasets").load_dataset(name, split=split,
                                             streaming=streaming)


def construct_hf_dataset(tag: str = "piano", limit: Optional[int] = None
                         ) -> Iterable[dict]:
    """The samples whose single genre tag equals ``tag`` (case-blind), at
    most ``limit`` of them."""
    count = 0
    for sample in download_hf_dataset():
        tags = sample.get("tags") or sample.get("genres") or []
        if isinstance(tags, str):
            tags = [tags]
        if len(tags) == 1 and tags[0].lower() == tag.lower():
            yield sample
            count += 1
            if limit is not None and count >= limit:
                return
