"""Multi-process runs over ``torch.distributed``: the process group of a
k-sharded sweep (``mesh``) and the slab halo exchange of a domain-
decomposed operator (``halo``). Port of ``bravais_tpu/parallel``."""

from bravais_tpu_torch.parallel.mesh import (KMesh, kpoint_mesh,  # noqa: F401
                                             replicated, shard_k)
