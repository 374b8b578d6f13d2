"""``python -m music_style_transfer_ldm_tpu_torch`` runs the CLI."""

from music_style_transfer_ldm_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
