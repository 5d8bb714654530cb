"""The one rule for where an entry point makes its tensors.

An entry point that builds tensors from host data (`makegridmetrics`,
`dma_peak_probe`, the `*_from_numpy` helpers) takes `device=`. Given, it
is used as it is. Left out (None), it means the current CUDA device, and
without a CUDA device the call raises: the port never falls back to the
CPU silently. Pass `device="cpu"` to run on the CPU, as the tests do.
Everything downstream follows the device of the tensors it is given.
"""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """`device` as a torch.device; None is the current CUDA device, and
    raises RuntimeError when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to run on the CPU')
    return torch.device("cuda", torch.cuda.current_device())
