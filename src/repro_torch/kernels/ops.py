"""Public entry points of the port's kernels, dispatched by device.

A CUDA tensor goes to the hand-written kernel (which launches or
raises); a CPU tensor goes to the plain PyTorch version.  There is no
mode that quietly trades one for the other: the caller picks the
device.  The other four kernels of the JAX package (flash_attention,
decode_attention, rglru, mlstm) are not ported yet (ROADMAP.md).
"""
from repro_torch.kernels.hub_route import hub_route
from repro_torch.kernels.minskew import minskew

__all__ = ["hub_route", "minskew"]
