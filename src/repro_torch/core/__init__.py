"""Host-side layout (schedules, packing, step sizes) and the NOMAD engine.

Submodules are imported explicitly (``repro_torch.core.partition``,
``repro_torch.core.nomad``, ...); importing this package loads none of
them.
"""
