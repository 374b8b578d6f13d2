"""The two training phases: autoencoder pretraining (AdamW, plateau on
the validation loss) and LDM training (Adam over all but the frozen
encoder), with the port's checkpoints."""

from music_style_transfer_ldm_tpu_torch.training.optim import (  # noqa: F401
    PlateauState, make_optimizer, plateau_init, plateau_update,
)
from music_style_transfer_ldm_tpu_torch.training.train_autoencoder import (  # noqa: F401,E501
    AETrainer,
)
from music_style_transfer_ldm_tpu_torch.training.train_ldm import (  # noqa: F401
    LDMTrainer,
)
