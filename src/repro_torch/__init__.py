"""ARCHES on PyTorch + CUDA: the port of ``repro`` to one NVIDIA H100.

Mirrors ``repro``'s layout (``phy/``, ``core/``, ``kernels/<name>/``,
``checkpoint/``) and imports neither ``jax`` nor ``repro``.  Every entry point takes an explicit
``device`` and defaults to ``"cuda"``; ``device="cpu"`` runs the plain
PyTorch versions of the hand-written kernels (what the CPU tests do).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
