"""The (dp, tp) device mesh and parameter placement
(counterpart of ``mars5_tts_tpu/parallel/mesh.py``).

Two named mesh dims over the ``torch.distributed`` world:

* ``dp``: data parallel (batch rows; replicas of a serving engine),
* ``tp``: tensor parallel (Megatron-style sharding of attention heads, FFN
  hidden dims and the vocabulary; ``parallel/sharding.py``).

Parameters become DTensors with a placement on each dim (always
``Replicate()`` on ``dp``); the collectives follow from the placements, as
XLA inserts them from sharding annotations in the JAX package. The process
group must be initialised first (``torch.distributed.init_process_group``
with an explicit ``init_method``, world size and rank).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, distribute_tensor


def make_mesh(dp: int | None = None, tp: int = 1, device_type: str | None = None) -> DeviceMesh:
    """A (dp, tp) mesh over the initialised world; dp defaults to
    world // tp. ``device_type`` defaults to ``cuda`` when PyTorch sees a
    card and the process group is not gloo alone, else ``cpu`` (a gloo
    group's collectives run on host tensors, card or none)."""
    n = dist.get_world_size()
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp * tp} != {n} devices")
    if device_type is None:
        cuda = torch.cuda.is_available() and dist.get_backend() != "gloo"
        device_type = "cuda" if cuda else "cpu"
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


def replicated(mesh: DeviceMesh) -> tuple:
    """The placements of a tensor held whole on every device of ``mesh``."""
    return (Replicate(),) * mesh.ndim


def shard_tree(mesh: DeviceMesh, module: nn.Module, specs: dict) -> nn.Module:
    """Place every parameter of ``module`` on ``mesh``, in place: its ``tp``
    placement from ``specs`` (parameter name -> placement; ``Replicate()``
    where absent), ``Replicate()`` on ``dp``. Values come from rank 0.
    Returns ``module``."""
    for name, p in list(module.named_parameters()):
        owner, leaf = name.rpartition(".")[::2]
        placements = (Replicate(), specs.get(name, Replicate()))
        dt = distribute_tensor(p.detach(), mesh, placements)
        setattr(module.get_submodule(owner), leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return module
