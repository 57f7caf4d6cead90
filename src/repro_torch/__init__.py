"""NOMAD matrix completion in PyTorch, with its block-SGD kernel written
in CUDA for Hopper.

The package mirrors the JAX package ``repro`` module for module (same
paths, same names) and runs on the card by default: entry points take
``device=None``, which means ``"cuda"``, and raise ``RuntimeError`` when
CUDA is unavailable instead of carrying on on the CPU.  Tests pass
``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version.

It imports ``torch`` and ``numpy`` only; nothing here imports JAX or the
``repro`` package.

    >>> from repro_torch import api
    >>> problem = api.MCProblem.synthetic(m=2000, n=400, nnz=80_000, k=16)
    >>> res = api.solve(problem, api.NomadConfig(k=16, p=8,
    ...                                          kernel="wave_pallas"))
"""
