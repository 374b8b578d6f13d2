"""The benchmark of music_style_transfer_ldm_tpu_torch on one NVIDIA
H100: a harness driven by the files of ``configs/``, ``traffic/`` and
``metrics/``, and the plain reference that decides ``correct``
(``reference/``).  Run a cell with ``python3 portbench/run.py``."""
