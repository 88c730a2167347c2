"""Process groups for k-point sharding and domain decomposition.

Port of ``bravais_tpu/parallel/mesh.py`` to ``torch.distributed``. The
reference builds a 1D ``jax.sharding.Mesh`` and lets XLA place the k axis
(``shard_k``) or a dof axis over it; here a ``KMesh`` holds one process's
place in a process group (its rank, the group size, its device and the
backend), and the collectives the port needs are its methods:

* ``all_reduce_``: a sum over the group in place (the LOBPCG ``reduce``
  hook of a domain-decomposed solve);
* ``shift``: every rank sends a tensor to the rank ``step`` after it and
  receives the one from ``step`` before it (the halo exchange of
  ``parallel/halo.py``);
* ``all_gather_object`` and ``broadcast_object``: host objects (a sweep's
  finished rows, a resume's finished k).

The backend is the caller's choice and is never switched: "nccl" (one
CUDA device per rank; the card's transport) or "gloo" (CPU tensors; CUDA
tensors only through explicit host copies, since gloo sends and receives
no CUDA tensor). ``transport`` names what a tensor's exchange runs on.

``shard_k`` and ``replicated`` are the counterparts of the reference's
shardings of the k axis: this rank's padded share of a k table, and
every rank's rows gathered back into k order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["KMesh", "kpoint_mesh", "shard_k", "replicated"]

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class KMesh:
    """One process's place in a process group: ``rank`` of ``size``, its
    ``device`` and the ``backend`` ("nccl" or "gloo"). ``owner``: this
    mesh formed the default group and ``close`` ends it."""

    rank: int
    size: int
    device: torch.device
    backend: str
    owner: bool = False

    def transport(self, t: torch.Tensor) -> str:
        """What an exchange of ``t`` runs on: "local" (a group of one: no
        exchange), "nccl", "gloo" (a CPU tensor) or "gloo via host" (a
        CUDA tensor copied to the host, exchanged and copied back)."""
        if self.size == 1:
            return "local"
        if self.backend == "nccl":
            return "nccl"
        return "gloo via host" if t.is_cuda else "gloo"

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group in place (every rank gets the same
        sum); returns ``t``. A group of one leaves it as it is."""
        if self.size == 1:
            return t
        stage = self._staged(t)
        buf = (t.to("cpu", copy=True) if stage
               else t if t.is_contiguous() else t.contiguous())
        dist.all_reduce(torch.view_as_real(buf) if buf.is_complex() else buf)
        if buf is not t:
            t.copy_(buf)
        return t

    def shift(self, t: torch.Tensor, step: int) -> torch.Tensor:
        """Send ``t`` to rank (rank + step) mod size and return the tensor
        of the same shape that rank (rank − step) mod size sent. A group
        of one returns ``t`` itself (the rank is its own neighbour)."""
        if self.size == 1:
            return t
        stage = self._staged(t)
        send = (t.to("cpu") if stage else t).contiguous()
        recv = torch.empty_like(send)
        real = (lambda x: torch.view_as_real(x)) if send.is_complex() \
            else (lambda x: x)
        ops = [dist.P2POp(dist.isend, real(send), (self.rank + step)
                          % self.size),
               dist.P2POp(dist.irecv, real(recv), (self.rank - step)
                          % self.size)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(t.device) if stage else recv

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s ``obj`` on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def close(self) -> None:
        """End the default group if this mesh formed it."""
        if self.owner and dist.is_initialized():
            dist.destroy_process_group()
            self.owner = False


def kpoint_mesh(backend: str, device=None, *, rank: Optional[int] = None,
                size: Optional[int] = None,
                init_method: Optional[str] = None) -> KMesh:
    """This process's ``KMesh`` over the default process group, formed
    here unless it exists.

    ``backend``: "nccl" or "gloo" (the caller's; never switched).
    ``rank``/``size``/``init_method`` given (e.g. a test's
    ``file://`` store): that group. Otherwise from a launcher's
    environment (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``, ``init_method="env://"``), and
    without one a group of one (an in-process store). ``device``: the
    rank's device, default ``cuda:{LOCAL_RANK}``; "cpu" runs on the host;
    "cuda" is ``cuda:{LOCAL_RANK}`` too. "nccl" needs a CUDA device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    env = os.environ
    if rank is None and "RANK" in env and "WORLD_SIZE" in env:
        rank, size = int(env["RANK"]), int(env["WORLD_SIZE"])
        init_method = init_method or "env://"
    if rank is None:
        rank, size = 0, 1
    if size is None:
        raise ValueError("kpoint_mesh: a rank needs its group's size")
    local = int(env.get("LOCAL_RANK", rank))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend runs on CUDA devices, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owner = False
    if not dist.is_initialized():
        if init_method is None and size == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=size)
        owner = True
    got = (dist.get_backend(), dist.get_rank(), dist.get_world_size())
    if got != (backend, rank, size):
        raise ValueError(f"the default process group is {got} (backend, "
                         f"rank, size), not {(backend, rank, size)}")
    return KMesh(rank=rank, size=size, device=dev, backend=backend,
                 owner=owner)


def shard_k(mesh: Optional[KMesh], k_cart: np.ndarray
            ) -> Tuple[np.ndarray, int, int]:
    """(this rank's share, its first index, how many of its rows are real
    k) of the k table ``k_cart`` (nk, d): the table padded with its last
    k to a multiple of the group size (the reference's padding) and cut
    into equal contiguous shares in rank order. Without a mesh: the whole
    table."""
    nk = len(k_cart)
    if mesh is None:
        return k_cart, 0, nk
    per = -(-nk // mesh.size)
    pad = np.concatenate([k_cart, np.repeat(k_cart[-1:], per * mesh.size
                                            - nk, axis=0)])
    lo = mesh.rank * per
    return pad[lo:lo + per], lo, max(0, min(per, nk - lo))


def replicated(mesh: Optional[KMesh], idx: List[int], rows: List[Any]
               ) -> Tuple[List[int], List[Any]]:
    """Every rank's ``rows`` (``idx``: their positions in the k table)
    gathered on every rank: (the positions ascending, their rows). Without
    a mesh: this process's, sorted."""
    parts = ([(list(idx), list(rows))] if mesh is None
             else mesh.all_gather_object((list(idx), list(rows))))
    pairs = sorted(((i, r) for ids, rs in parts for i, r in zip(ids, rs)),
                   key=lambda p: p[0])
    return [i for i, _ in pairs], [r for _, r in pairs]
