"""In-repo optimizers: AdamW with a configurable state dtype and an fp32
master copy, and SGD with momentum, in the JAX package's arithmetic.

AdamW with ``state_dtype='bfloat16'`` halves the m/v memory.  Master
weights: updates are computed in fp32 from the (bf16) parameters; with
``master_dtype='float32'`` an fp32 master copy is kept (classic mixed
precision), with ``None`` the parameters are the only copy.

``params`` is the port's ``Transformer`` (any ``nn.Module``) or a dict
of tensors; the state holds dicts keyed by the parameter names
(``named_parameters``), ``grads`` is keyed the same way.  Where the
reference returns new trees, the port updates the parameters and the
state in place, under ``torch.no_grad()``, and returns them: the
arithmetic is the reference's, operation for operation (the clip
``min(1, clip / max(|g|, 1e-12))``, bias corrections from the step as
fp32, ``master - lr (m^ / (sqrt(v^) + eps) + wd master)``).  It is not
``torch.optim.AdamW``, whose decoupled decay rounds differently and which
keeps neither a master copy nor bf16 state.

On a mesh (``ctx``, a ``distributed.sharding.ShardingCtx``) the
parameters, gradients, m, v and master are each rank's blocks under the
parameters' specs; only the clip is global, from
``sharding.global_norm``, so every rank gets the same ``grad_norm`` and
clip and the update is the unsharded one, block by block.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..distributed import sharding


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"     # 'float32' | 'bfloat16'
    master_dtype: Optional[str] = "float32"   # None -> no master copy
    grad_clip: float = 1.0


def named(params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters, or the dict itself."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _device(tensors: Dict[str, torch.Tensor]) -> torch.device:
    return next(iter(tensors.values())).device


@torch.no_grad()
def adamw_init(params, cfg: AdamWConfig) -> dict:
    """``{"m", "v"}`` zeros in ``state_dtype``, ``"step"`` a 0-d int32
    tensor, and ``"master"`` (unless ``master_dtype`` is None) a copy of
    the parameters in ``master_dtype``; on the parameters' device."""
    ps = named(params)
    sd = getattr(torch, cfg.state_dtype)
    state = {"m": {k: torch.zeros_like(p, dtype=sd) for k, p in ps.items()},
             "v": {k: torch.zeros_like(p, dtype=sd) for k, p in ps.items()},
             "step": torch.zeros((), dtype=torch.int32, device=_device(ps))}
    if cfg.master_dtype is not None:
        md = getattr(torch, cfg.master_dtype)
        state["master"] = {k: p.detach().to(md, copy=True)
                           for k, p in ps.items()}
    return state


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of their fp32 sums of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0, *,
                 ctx=None):
    """One AdamW step.  Updates ``params`` and ``state`` in place and
    returns ``(params, state, metrics)``, metrics ``{"grad_norm", "lr"}``
    as 0-d fp32 tensors.  ``lr_scale`` is a number or a 0-d tensor (a
    schedule's value).  With ``ctx`` everything is this rank's blocks
    and the clip uses the global norm of all ranks' blocks."""
    ps = named(params)
    if set(grads) != set(ps):
        raise ValueError(f"grads for {sorted(set(grads) ^ set(ps))} do not "
                         "match the parameters")
    dev = _device(ps)
    state["step"] += 1
    step = state["step"].to(torch.float32)
    if ctx is None:
        gnorm = global_norm(grads[k] for k in ps)
    else:
        gnorm = sharding.global_norm({k: grads[k] for k in ps}, ctx)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step)
    bc2 = 1.0 - torch.pow(b2, step)
    lr = torch.as_tensor(cfg.lr * lr_scale, dtype=torch.float32, device=dev)
    masters = state.get("master", ps)
    for k, p in ps.items():
        m, v, master = state["m"][k], state["v"][k], masters[k]
        g = grads[k].float() * clip
        m32 = m.float().mul_(b1).add_((1 - b1) * g)
        v32 = v.float().mul_(b2).add_((1 - b2) * g * g)
        del g
        upd = (m32 / bc1).div_(torch.sqrt(v32 / bc2).add_(cfg.eps))
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        mw = master.float()
        upd.add_(cfg.weight_decay * mw).mul_(lr)
        new_master = mw.sub_(upd) if mw is not master else mw - upd
        del upd
        p.copy_(new_master)
        if master is not p:
            master.copy_(new_master)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ----------------------------------------------------------------- #
# SGD + momentum                                                      #
# ----------------------------------------------------------------- #

@torch.no_grad()
def sgdm_init(params, momentum=0.9) -> dict:
    ps = named(params)
    return {"mom": {k: torch.zeros_like(p) for k, p in ps.items()},
            "step": torch.zeros((), dtype=torch.int32, device=_device(ps))}


@torch.no_grad()
def sgdm_update(params, grads, state, lr, momentum=0.9):
    """``mom = momentum * mom + g``, ``p = p - lr * mom``, in place;
    returns ``(params, state)``."""
    for k, p in named(params).items():
        mom = state["mom"][k]
        mom.copy_(momentum * mom + grads[k])
        p.copy_(p - lr * mom)
    state["step"] += 1
    return params, state
