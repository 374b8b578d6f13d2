"""Evaluation and diagnostics: the training-independent transfer
metrics (``metrics.py``) and the reference's run-by-hand model checks as
a library (``diagnostics.py``)."""

from music_style_transfer_ldm_tpu_torch.evaluation.diagnostics import (  # noqa: F401,E501
    detect_dead_style_encoder, forward_visualization, ldm_forward_panel,
    mel_db_distance, parameter_table, reconstruction_grid,
    spectral_convergence, style_embedding_stats,
)
from music_style_transfer_ldm_tpu_torch.evaluation.metrics import (  # noqa: F401
    band_statistics, batch_spectral_convergence, fad_metrics,
    frechet_distance, independent_transfer_metrics, log_mel_stats_distance,
    style_distance_reductions_multiseed, style_distances_multiseed,
    trunk_embeddings,
)
