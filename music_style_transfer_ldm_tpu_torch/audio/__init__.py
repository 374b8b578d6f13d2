"""The DSP chain in batched PyTorch: the port's replacement for the
reference's librosa calls.

Submodules (functions whose names collide with their module, ``stft``
and ``nnls``, are reached through the module):

  stft        framing, STFT, ISTFT
  mel         mel filterbank, mel spectrogram, dB math
  quantize    dB <-> uint8 / [0, 1] image codec
  nnls        batched FISTA mel inversion
  griffinlim  Griffin-Lim and mel_to_audio
  io          host WAV / ffmpeg file I/O (loads on first use: scipy)
  processor   the AudioProcessor facade (loads on first use: it imports
              the front end's kernel wrapper, which imports this package)
"""

from music_style_transfer_ldm_tpu_torch.audio import (  # noqa: F401
    griffinlim, mel, nnls, quantize, stft,
)
from music_style_transfer_ldm_tpu_torch.audio.stft import (  # noqa: F401
    frame_signal, hann_window, istft, num_frames,
)
from music_style_transfer_ldm_tpu_torch.audio.mel import (  # noqa: F401
    amplitude_to_db, db_to_amplitude, db_to_power, hz_to_mel, mel_filterbank,
    mel_to_hz, melspectrogram, power_to_db,
)
from music_style_transfer_ldm_tpu_torch.audio.quantize import (  # noqa: F401
    db_to_uint8_image, db_to_unit_image, uint8_image_to_db, unit_image_to_db,
    unit_image_to_uint8,
)
from music_style_transfer_ldm_tpu_torch.audio.griffinlim import (  # noqa: F401
    griffin_lim, mel_to_audio, mel_to_stft,
)
from music_style_transfer_ldm_tpu_torch.utils.lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {
    "io": "io", "AudioProcessor": "processor"})
