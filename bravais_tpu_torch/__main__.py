"""`python -m bravais_tpu_torch` — the band-structure CLI
(the same as `python -m bravais_tpu_torch.cli.bands_app`)."""

import sys

from bravais_tpu_torch.cli.bands_app import main

sys.exit(main())
