"""Host-side layout (schedules, packing, step sizes), the NOMAD engine,
and the paper's baselines.

``baselines`` (DSGD, CCD++, ALS, Hogwild) is exported as in the JAX
package, loaded on first access; the other submodules are imported
explicitly (``repro_torch.core.partition``, ``repro_torch.core.nomad``,
...).  Importing this package loads none of them.
"""

__all__ = ["baselines"]


def __getattr__(name):
    if name == "baselines":
        import importlib
        return importlib.import_module(f"{__name__}.baselines")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
