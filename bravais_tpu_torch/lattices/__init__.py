from bravais_tpu_torch.lattices.data import (  # noqa: F401
    LATTICE_NAMES, LATTICE_NAMES_2D, Lattice, make_lattice,
)
from bravais_tpu_torch.lattices.kpath import KPath, kpath  # noqa: F401
