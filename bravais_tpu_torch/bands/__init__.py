from bravais_tpu_torch.bands.sweep import BandSweep, SweepResult  # noqa: F401
from bravais_tpu_torch.bands.io import (  # noqa: F401
    BandWriter, load_bands, plot_bands, save_modes, write_csv, write_vtk)
