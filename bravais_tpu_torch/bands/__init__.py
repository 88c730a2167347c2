from bravais_tpu_torch.bands.sweep import BandSweep, SweepResult  # noqa: F401
