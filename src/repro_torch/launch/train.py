"""Training step factory + CLI trainer.

``make_train_step`` builds the ``(state, batch) -> (state, metrics)``
function the trainer below runs.  A train state is ``{"params": the
port's Transformer, "opt": adamw_init's state}``; the step updates both
in place (the reference returns new trees) and returns them.

CLI (a real small-model training on the card, or ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_32b \\
        --smoke --steps 50 --ckpt-dir /tmp/ckpt

Checkpoints are written in the JAX package's layout
(``checkpoint.save_train_state``), so either package resumes the other's.

On a (data, model) mesh of ranks (``ctx``, a
``distributed.sharding.ShardingCtx``; every family: dense, MoE, SSM and
hybrid), every rank calls the same functions with the same whole batch:
``init_state(..., ctx=ctx)`` draws the whole model and keeps the rank's
blocks with AdamW's m, v and master of them, and the step computes the
rank's share of the global loss, sums over dp the gradients no FSDP
gather has reduced (``sharding.reduce_grads``) and clips by the global
norm.  The CLI trains without a mesh, as the reference's does.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from .._device import resolve_device
from ..convert import shard_lm_params
from ..distributed import sharding
from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim import adamw as optim
from ..optim.schedule import cosine_warmup

#: the metrics of a step, in the order they are averaged over microbatches
METRICS = ("loss", "xent", "aux_loss", "dropped")


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``TokenPipeline.batch_at``) or tensors as
    tensors on ``device``: integer arrays as int64 (token ids and
    positions index with them), floats as they are."""
    out = {}
    for key, x in batch.items():
        t = torch.as_tensor(x)
        if not t.is_floating_point():
            t = t.long()
        out[key] = t.to(device)
    return out


def grads_and_metrics(params: T.Transformer, cfg: ModelConfig, batch, *,
                      ctx=None, impl: str = "pallas", grad_accum: int = 1):
    """``({name: gradient}, metrics)`` of ``loss_and_metrics`` at
    ``params`` on ``batch``.  With ``grad_accum > 1`` the batch is split
    into that many microbatches run one after another; their gradients
    are summed in fp32, each divided by ``grad_accum``, and the metrics
    averaged (the reference's ``lax.scan``).  Otherwise the gradients are
    in the parameters' dtype.

    With ``ctx``: ``batch`` is the global batch (split into microbatches
    first, each then cut to the rank's rows), the gradients are the
    rank's blocks of the global loss's, summed over dp where no gather
    did (``sharding.reduce_grads``), and the metrics the global ones."""
    named = dict(params.named_parameters())
    B = batch["inputs"].shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} is not a multiple of grad_accum "
                         f"{grad_accum}")
    n = B // grad_accum

    def one(mb):
        loss, metrics = T.loss_and_metrics(params, cfg, mb, ctx=ctx,
                                           impl=impl)
        grads = torch.autograd.grad(loss, list(named.values()))
        return grads, {k: metrics[k].detach() for k in METRICS}

    was = {k: p.requires_grad for k, p in named.items()}
    try:
        for p in named.values():
            p.requires_grad_(True)
        if grad_accum == 1:
            grads, metrics = one(batch)
            grads = dict(zip(named, grads))
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named.items()}
            sums = dict.fromkeys(METRICS, 0.0)
            for i in range(grad_accum):
                part, m = one({k: x[i * n:(i + 1) * n]
                               for k, x in batch.items()})
                for a, g in zip(grads.values(), part):
                    a.add_(g.float() / grad_accum)
                del part
                for k in METRICS:
                    sums[k] = sums[k] + m[k]
            metrics = {k: v / grad_accum for k, v in sums.items()}
    finally:
        for k, p in named.items():
            p.requires_grad_(was[k])
    if ctx is not None:
        grads = sharding.reduce_grads(grads, ctx)
    return grads, metrics


def make_train_step(cfg: ModelConfig, ctx, opt_cfg: optim.AdamWConfig, *,
                    impl: str = "pallas", total_steps: int = 10000,
                    warmup: int = 100, grad_accum: int = 1):
    """(state, batch) -> (state, metrics).

    ``impl="pallas"`` (the default) runs attention's forward through the
    flash kernel on the card; the reference trains on ``"xla"`` because
    its Pallas kernel has no VJP.  ``grad_accum > 1`` splits the batch
    into microbatches with fp32 gradient accumulation (live activations
    shrink by the factor; the arithmetic is the same).  ``batch`` holds
    numpy arrays or tensors; they are moved to the model's device.
    Metrics are 0-d tensors: ``loss``, ``xent``, ``aux_loss``,
    ``dropped``, ``grad_norm``, ``lr``.

    With ``ctx`` the state is the rank's (``init_state(..., ctx=ctx)``)
    and every rank runs the step on the same global batch; the metrics
    are the global batch's, equal on every rank.  Raises ``TypeError``
    for a ctx that is not a ``ShardingCtx`` and ``ValueError`` where the
    mesh does not divide the config."""
    T._check_ctx(cfg, ctx)

    def train_step(state, batch):
        params = state["params"]
        batch = to_device(batch, params.lm_head.w.device)
        grads, metrics = grads_and_metrics(params, cfg, batch, ctx=ctx,
                                           impl=impl, grad_accum=grad_accum)
        lr_scale = cosine_warmup(state["opt"]["step"], base_lr=1.0,
                                 warmup=warmup, total=total_steps)
        _, _, opt_metrics = optim.adamw_update(params, grads, state["opt"],
                                               opt_cfg, lr_scale=lr_scale,
                                               ctx=ctx)
        return state, {**metrics, **opt_metrics}

    return train_step


def init_state(key, cfg: ModelConfig, opt_cfg: optim.AdamWConfig, *,
               device=None, ctx=None) -> dict:
    """A fresh train state on ``device`` (``None`` = ``"cuda"``): the
    model from ``init_params(key, cfg)`` and its AdamW state.  With
    ``ctx`` the whole model is drawn, then cut to the rank's blocks
    (``convert.shard_lm_params``), and the AdamW state is of the blocks:
    its master holds the blocks of the unsharded master
    (``launch.specs.train_state_struct`` gives their shapes and
    specs)."""
    T._check_ctx(cfg, ctx)
    params = T.init_params(key, cfg, device=resolve_device(device))
    if ctx is not None:
        params = shard_lm_params(params, cfg, ctx)
    return {"params": params, "opt": optim.adamw_init(params, opt_cfg)}


def main(argv=None):
    import argparse
    from .. import configs
    from ..checkpoint import AsyncCheckpointer, restore_train_state
    from ..convert import train_state_to_reference
    from ..data.pipeline import TokenPipeline

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_32b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    opt_cfg = optim.AdamWConfig(lr=args.lr)
    step_fn = make_train_step(cfg, None, opt_cfg, total_steps=args.steps)

    state = init_state(0, cfg, opt_cfg, device=dev)
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        restored, rstep = restore_train_state(args.ckpt_dir, state, cfg)
        if restored is not None:
            state, start_step = restored, rstep
            print(f"resumed from step {rstep}")

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch,
                         embed_input=cfg.embed_input, d_model=cfg.d_model)
    t0 = time.time()
    for step in range(start_step, args.steps):
        state, metrics = step_fn(state, pipe.batch_at(step))
        if step % 10 == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, train_state_to_reference(state, cfg))
    if ckpt:
        ckpt.wait()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    n = args.steps - start_step
    print(f"{n} steps in {dt:.1f}s ({n / max(dt, 1e-9):.2f} steps/s) "
          f"on {dev}")


if __name__ == "__main__":
    main()
