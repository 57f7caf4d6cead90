"""Carry the JAX package's parameters across.  For matrix completion the
parameters are the factors: global ``W (m, k)`` / ``H (n, k)`` numpy
arrays, as a reference ``FitResult`` or checkpoint holds them, on one
side, and the port's sharded ``(p, m_local, k)`` / ``(p, n_local, k)``
torch tensors on the other.  For serving, :func:`serving_factors` turns
the same global arrays (and an int8 view's scales) into the tensors the
port's ``FactorStore`` publishes.  For the LM, :func:`lm_params_from_reference`
unstacks the reference's period-stacked parameter tree into the port's
``Transformer`` (one module per layer), and :func:`lm_params_to_reference`
stacks it back; :func:`shard_lm_params` cuts one rank's blocks out of
either for sharded serving; :func:`train_state_from_reference` and
:func:`train_state_to_reference` carry a whole train state (parameters,
AdamW's m, v and master copy, the step) the same way.

bf16 travels through an fp32 carrier (numpy has no bfloat16 of its own;
the reference checkpoint stores bf16 the same way): every bf16 value is
exact in fp32, so the round trip is lossless.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ._device import resolve_device
from .core import partition as part
from .kernels.policy import KernelPolicy


def factors_from_reference(W, H, br: part.BlockedRatings, *,
                           dtype_policy: str = "fp32",
                           device: Optional[Union[str, torch.device]] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard global numpy factors for ``br`` and store them in the
    policy's storage dtype on ``device`` (``None`` = ``"cuda"``).
    Padding rows are zero."""
    dev = resolve_device(device)
    sd = KernelPolicy(dtype_policy=dtype_policy).storage_dtype
    Ws, Hs = part.shard_factors(np.asarray(W).astype(np.float32),
                                np.asarray(H).astype(np.float32), br)
    return (torch.from_numpy(Ws).to(device=dev, dtype=sd),
            torch.from_numpy(Hs).to(device=dev, dtype=sd))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host (bf16 as its fp32 carrier)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)         # the fp32 carrier
    return t.numpy()


def factors_to_reference(Ws: torch.Tensor, Hs: torch.Tensor,
                         br: part.BlockedRatings
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather sharded factors back into global numpy ``(W, H)``: fp32 and
    fp16 keep their dtype, bf16 comes back as its fp32 carrier."""
    return part.unshard_factors(to_numpy(Ws), to_numpy(Hs), br)


def serving_array(A, device: Optional[Union[str, torch.device]] = None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One factor array as the serving store holds it: a tensor on
    ``device`` (``None`` = ``"cuda"``), in ``dtype`` when given (the fp32
    carrier of bf16 factors back to bf16, exactly).  Takes numpy arrays,
    bfloat16 ones from the JAX package included (their dtype is named
    ``"bfloat16"``; they travel as their fp32 carrier), and tensors."""
    dev = resolve_device(device)
    if not isinstance(A, torch.Tensor):
        A = np.asarray(A)
        if A.dtype.name == "bfloat16":
            A = torch.from_numpy(A.astype(np.float32)).to(torch.bfloat16)
        else:
            A = torch.from_numpy(np.array(A, order="C"))
    return A.to(device=dev, dtype=dtype).contiguous()


def serving_factors(W, H, *, w_scale=None, h_scale=None,
                    dtype_policy: Optional[str] = None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> dict:
    """A reference ``FitResult``'s or ``FactorView``'s global ``W``/``H``
    (and, for an int8 view, its ``w_scale``/``h_scale``) as the fields of
    the port's ``FactorView``: tensors on ``device``.  ``dtype_policy``
    stores the factors in that policy's dtype (a bf16 run's fp32 carrier
    as bf16); ``None`` keeps their own dtype."""
    sd = (None if dtype_policy is None
          else KernelPolicy(dtype_policy=dtype_policy).storage_dtype)
    out = dict(W=serving_array(W, device, sd), H=serving_array(H, device, sd),
               w_scale=None, h_scale=None)
    if (w_scale is None) != (h_scale is None):
        raise ValueError("w_scale and h_scale come together")
    if w_scale is not None:
        out["w_scale"] = serving_array(w_scale, device, torch.float32)
        out["h_scale"] = serving_array(h_scale, device, torch.float32)
    return out


# --------------------------------------------------------------------- #
# LM parameters                                                         #
# --------------------------------------------------------------------- #

def _flatten(tree, prefix: str = ""):
    """``{"a": {"b": x}}`` -> ``{"a.b": x}``; lists index by position."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for key, val in items:
        name = f"{prefix}{key}"
        if isinstance(val, (dict, list, tuple)):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _layer_trees(params_np, cfg):
    """The reference's per-layer parameter trees, unstacked: the prologue
    layers, then layer ``n_prologue + s * period + pos`` from step ``s``
    of ``blocks["pos<pos>"]``."""
    out = list(params_np.get("prologue", []))
    for idx in range(cfg.n_prologue, cfg.n_layers):
        s, pos = divmod(idx - cfg.n_prologue, cfg.period)
        block = _flatten(params_np["blocks"][f"pos{pos}"])
        out.append({name: a[s] for name, a in block.items()})
    return [_flatten(t) for t in out]


def _lm_flat_from_reference(tree, cfg) -> dict:
    """A reference LM tree (parameters, or an optimizer tree shaped like
    them) as ``{port parameter name: leaf}``."""
    flat = {k: v for k, v in _flatten(tree).items()
            if not k.startswith(("blocks.", "prologue."))}
    for i, layer in enumerate(_layer_trees(tree, cfg)):
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return flat


def _torch_dtype(a) -> torch.dtype:
    return a.dtype if isinstance(a, torch.Tensor) else getattr(
        torch, np.asarray(a).dtype.name)


def lm_params_from_reference(params_np, cfg, *, dtype=None, device=None):
    """The JAX package's LM parameter tree (``init_params``'s, as numpy
    arrays: ``jax.tree.map(np.asarray, params)``) as the port's
    ``Transformer`` on ``device`` (``None`` = ``"cuda"``).  The period axis
    is unstacked into one module per layer.  Weights are stored in
    ``dtype`` (``None``: the dtype of the reference's ``lm_head``); the
    leaves the reference keeps in fp32 whatever the model's dtype (norm
    scales, the MoE router, Mamba's ``dt_bias``, ``A_log`` and ``D``)
    stay fp32; bf16 comes through its fp32 carrier, exactly."""
    from .models.transformer import Transformer
    dev = resolve_device(device)
    if dtype is None:
        dtype = _torch_dtype(params_np["lm_head"]["w"])
    flat = _lm_flat_from_reference(params_np, cfg)
    model = Transformer(cfg, dtype=dtype, device=dev)
    state = model.state_dict()
    if set(state) != set(flat):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(state) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(state))}")
    with torch.no_grad():
        for name, t in state.items():
            src = serving_array(flat[name], dev)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, the "
                                 f"model wants {tuple(t.shape)}")
            t.copy_(src)
    return model


def shard_lm_params(full, cfg, ctx, *, device=None):
    """This rank's blocks of an LM's parameters under ``ctx`` (a
    ``distributed.sharding.ShardingCtx``): each tensor cut by its spec
    (``sharding.shard_param``: the reference's rules, with Mamba's
    ``in_proj`` cut half by half), so a sharded run computes with exactly
    the weights of the unsharded one.  ``full`` is
    the port's ``Transformer`` or the reference's numpy tree (as
    :func:`lm_params_from_reference` takes it, built on the CPU first).
    Returns a ``Transformer`` whose parameters are the blocks, copies on
    ``device`` (``None``: ``full``'s device, or ``"cuda"`` for a tree) in
    their own dtypes.  Raises ``ValueError`` when the mesh
    does not divide the config (``sharding.check_divisible``)."""
    from .distributed.sharding import check_divisible, shard_param
    from .models.transformer import Transformer
    check_divisible(cfg, ctx)
    if isinstance(full, dict):
        full = lm_params_from_reference(full, cfg, device="cpu")
        dev = resolve_device(device)
    else:
        dev = full.lm_head.w.device if device is None else resolve_device(
            device)
    model = Transformer(cfg, dtype=full.dtype, device="meta")
    with torch.no_grad():
        for name, t in full.state_dict().items():
            block = shard_param(name, t, ctx)
            path, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(path), leaf, torch.nn.Parameter(
                block.to(dev, copy=True).contiguous(), requires_grad=False))
    return model


def _lm_tree(flat: dict, cfg, stack) -> dict:
    """``{port parameter name: leaf}`` as the reference's tree, layers
    stacked on the period axis by ``stack``."""
    def nest(items):
        out: dict = {}
        for name, a in items.items():
            *path, leaf = name.split(".")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
        return out

    per_layer = [nest({k[len(f"layers.{i}."):]: v for k, v in flat.items()
                       if k.startswith(f"layers.{i}.")})
                 for i in range(cfg.n_layers)]
    tree = nest({k: v for k, v in flat.items()
                 if not k.startswith("layers.")})
    tree["prologue"] = per_layer[:cfg.n_prologue]
    body = per_layer[cfg.n_prologue:]
    tree["blocks"] = {
        f"pos{pos}": nest({k: stack([_flatten(t)[k]
                                     for t in body[pos::cfg.period]])
                           for k in _flatten(body[pos])})
        for pos in range(cfg.period)}
    return tree


def lm_params_to_reference(model, cfg) -> dict:
    """The inverse of :func:`lm_params_from_reference`: the reference's
    tree of numpy arrays, layers stacked on the period axis again (bf16
    as its fp32 carrier)."""
    return _lm_tree({k: to_numpy(v) for k, v in model.state_dict().items()},
                    cfg, np.stack)


# --------------------------------------------------------------------- #
# LM train states                                                       #
# --------------------------------------------------------------------- #

def train_state_from_reference(state_np, cfg, *, device=None) -> dict:
    """The JAX package's train state (``launch.train.init_state``'s
    ``{"params", "opt": {"m", "v", "step"[, "master"]}}``, leaves as
    numpy arrays or CPU tensors, as a reference checkpoint restores) as
    the port's: ``{"params": Transformer, "opt": {name-keyed tensors,
    "step": 0-d int32}}`` on ``device`` (``None`` = ``"cuda"``).  Every
    leaf keeps its dtype (bf16 through its carrier, exactly)."""
    params_np, opt_np = state_np["params"], state_np["opt"]
    params = lm_params_from_reference(params_np, cfg, device=device)
    dev = params.lm_head.w.device
    names = [k for k, _ in params.named_parameters()]

    def tensors(tree):
        flat = _lm_flat_from_reference(tree, cfg)
        if set(flat) != set(names):
            raise ValueError(f"optimizer names differ from the parameters': "
                             f"{sorted(set(flat) ^ set(names))}")
        return {k: serving_array(flat[k], dev) for k in names}

    opt = {"m": tensors(opt_np["m"]), "v": tensors(opt_np["v"]),
           "step": torch.tensor(int(opt_np["step"]), dtype=torch.int32,
                                device=dev)}
    if "master" in opt_np:
        opt["master"] = tensors(opt_np["master"])
    return {"params": params, "opt": opt}


def _train_tree(state, cfg, leaf, stack) -> dict:
    opt = state["opt"]
    out = {"params": _lm_tree({k: leaf(v) for k, v in
                               state["params"].state_dict().items()},
                              cfg, stack),
           "opt": {k: _lm_tree({n: leaf(t) for n, t in opt[k].items()},
                               cfg, stack)
                   for k in ("m", "v", "master") if k in opt}}
    out["opt"]["step"] = leaf(opt["step"])
    return out


def train_state_to_reference(state, cfg) -> dict:
    """The inverse of :func:`train_state_from_reference`: the reference's
    train-state tree of numpy arrays (bf16 as its fp32 carrier, the step
    a 0-d int32 array), what ``repro.checkpoint`` saves."""
    return _train_tree(state, cfg, to_numpy, np.stack)


def train_state_template(state, cfg) -> dict:
    """:func:`train_state_to_reference`'s tree with meta tensors of each
    leaf's shape and dtype: a restore template that copies nothing."""
    return _train_tree(state, cfg,
                       lambda t: torch.empty_like(t, device="meta"),
                       torch.stack)
