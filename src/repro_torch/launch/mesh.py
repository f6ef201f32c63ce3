"""Shim of the reference's ``repro.launch.mesh``: the training mesh factories
live in ``repro_torch.core.topology``."""

from repro_torch.core.topology import make_cpu_mesh, make_production_mesh  # noqa: F401
