"""LM serving: prefill + decode step factories and a batched-request CLI.

    python -m repro_torch.launch.serve --arch qwen2_5_32b --batch 4 \\
        --prompt-len 1024 --gen 32 --temperature 0
    python -m repro_torch.launch.serve --smoke --device cpu --temperature 0
    python -m repro_torch.launch.serve --smoke --device cpu --mesh 2x2 \\
        --temperature 0

Runs on the card (``--device`` defaults to ``cuda``).  ``--mesh DxM``
serves on a (data, model) mesh of ``D x M`` ranks, one process each
(``launch.mesh.spawn_ranks``): every rank draws the whole model from the
seed and keeps its blocks (``convert.shard_lm_params``); rank 0 prints.
Every family serves so, the MoE expert-parallel and the SSM
``d_inner``-parallel::

    python -m repro_torch.launch.serve --arch qwen3_moe_30b_a3b --layers 2 \\
        --mesh 2x2 --temperature 0

Unlike the JAX package's CLI, whose ``make_prefill`` defaults to
``impl="xla"``, the port's prefill defaults to ``impl="pallas"``: on the
card every layer's prefill attention is the CUDA flash kernel (ROADMAP
Queue 3 lists the difference).  The matrix-completion serving CLI is
:mod:`repro_torch.launch.serve_mc`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..distributed import tp
from ..models import transformer as T
from ..models.attention import KVCache
from ..models.config import ModelConfig


#: seconds the ranks of ``--mesh`` may take before they are killed
MESH_TIMEOUT = 3600.0


def make_prefill(cfg: ModelConfig, ctx=None, *, impl: str = "pallas"):
    def prefill_fn(params, batch):
        return T.prefill(params, cfg, batch["inputs"],
                         positions=batch.get("positions"), ctx=ctx,
                         impl=impl)
    return prefill_fn


def make_decode_step(cfg: ModelConfig, ctx=None):
    def decode_fn(params, batch, cache, pos):
        return T.decode_step(params, cfg, batch["inputs"], cache, pos,
                             ctx=ctx)
    return decode_fn


def _merge_prefill_cache(full_cache, pre_cache, cfg, P, *, ctx=None,
                         batch=None):
    """Write the prefill's KV (length ``P``) into the zero-initialised
    full-length caches, in place; an SSM layer's state carries over
    unchanged (its slot in the list is replaced).  Returns the list.

    With ``ctx`` (a batch of ``batch``): the prefill's KV holds the rank's
    ``Hkv/tp`` heads of every position (where tp exceeds the KV heads, its
    ``1/r`` column slice of one head: ``models.attention``), the caches
    the rank's slice of the positions with every head (``launch.specs``);
    one all-to-all over the model axis carries every attention layer's k
    and v slice to the rank that holds it, the ranks' columns side by side
    in rank order.  An SSM layer's state is already the rank's block (its
    ``d_inner/tp`` channels) and goes into its slot as it is."""
    if ctx is not None:
        return _reshard_prefill_cache(full_cache, pre_cache, P, ctx, batch)
    for i, (dst, src) in enumerate(zip(full_cache, pre_cache)):
        if isinstance(dst, KVCache):
            dst.k[:, :P] = src.k.to(dst.k.dtype)
            dst.v[:, :P] = src.v.to(dst.v.dtype)
        else:
            full_cache[i] = src
    return full_cache


def _reshard_prefill_cache(full_cache, pre_cache, P, ctx, batch):
    attn = [i for i, c in enumerate(full_cache) if isinstance(c, KVCache)]
    for i, c in enumerate(pre_cache):
        if i not in attn:
            full_cache[i] = c
    if not attn:
        return full_cache
    S_loc, m = full_cache[attn[0]].k.shape[1], ctx.tp_size
    # the positions of this model group's m slices start at base: with the
    # batch replicated the slices run over every rank, dp's first
    base = 0 if tp.batch_sharded(batch, ctx) else ctx.dp_index * m * S_loc
    kv = torch.stack([t for i in attn for t in (pre_cache[i].k,
                                                pre_cache[i].v)])
    L2, Bl, _, h, D = kv.shape          # (2 L, B, P, Hkv/tp, D) or D/r
    send = kv.new_zeros((L2, Bl, m * S_loc, h, D),
                        dtype=full_cache[attn[0]].k.dtype)
    hi = min(P, base + m * S_loc)
    if hi > base:
        send[:, :, :hi - base] = kv[:, :, base:hi]
    send = send.reshape(L2, Bl, m, S_loc, h, D).movedim(2, 0).contiguous()
    got = ctx.mesh.all_to_all(send, ctx.tp)     # (m, 2 L, B, S_loc, h, D)
    got = got.permute(1, 2, 3, 0, 4, 5).reshape(
        L2, Bl, S_loc, *full_cache[attn[0]].k.shape[2:])
    for j, i in enumerate(attn):
        full_cache[i].k.copy_(got[2 * j])
        full_cache[i].v.copy_(got[2 * j + 1])
    return full_cache


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _next_token(logits, temperature: float, generator):
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def _all_rows(tok, ctx, B: int):
    """The whole batch's tokens from this rank's rows (gathered over dp
    when the batch is sharded)."""
    if ctx is None or not tp.batch_sharded(B, ctx):
        return tok
    return ctx.mesh.all_gather(tok, ctx.dp, dim=0)


def generate(params, cfg: ModelConfig, prompts, gen: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, ctx=None,
             keep_logits: bool = False, around=None):
    """Serve one batch as the CLI does: prefill ``prompts`` (B, P), move
    its KV into caches of the ``P + gen - 1`` positions decode writes,
    take the first token from the prefill's logits (greedy) and then
    ``gen - 1`` decode steps, each sampling at ``temperature`` (0 =
    greedy) from ``generator``.  Returns ``(tokens (B, gen), timings)``
    with ``prefill_s`` (prefill and merge) and ``decode_s``, each ended
    by a device synchronisation, and ``cache``, the caches after the last
    step; with ``keep_logits`` also ``logits``, each step's (B, V).
    ``around(kind)``, where given, is a context manager entered around
    each call of the prefill (``kind`` ``"prefill"``) and of the decode
    step (``"decode"``): a per-call record (``testing.StepLog``).

    With ``ctx``: every rank passes the whole batch and its blocks of the
    weights (``convert.shard_lm_params``); the logits are gathered over
    the model axis where a token is chosen, the tokens over dp, so every
    rank returns the whole batch's tokens (and its rows' ``logits``).
    Sampling then needs ``generator`` seeded alike on every rank."""
    B, P = prompts.shape[:2]
    dev = prompts.device
    prefill_fn = make_prefill(cfg, ctx)
    decode_fn = make_decode_step(cfg, ctx)
    around = around or (lambda kind: contextlib.nullcontext())

    _sync(dev)
    t0 = time.perf_counter()
    with around("prefill"):
        logits, pre_cache = prefill_fn(params, {"inputs": prompts})
    cache = T.init_cache(cfg, B, P + gen - 1, device=dev,
                         dtype=params.dtype, ctx=ctx)
    cache = _merge_prefill_cache(cache, pre_cache, cfg, P, ctx=ctx, batch=B)
    del pre_cache
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    logits = T.gather_logits(logits, ctx)
    kept = [logits]
    tok = _all_rows(torch.argmax(logits, dim=-1), ctx, B)
    out = [tok]
    eye = torch.arange(cfg.d_model, device=dev)
    t0 = time.perf_counter()
    for i in range(gen - 1):
        inp = (tok[:, None] if cfg.embed_input
               else (tok[:, None] == eye).to(params.dtype)[:, None])
        with around("decode"):
            logits, cache = decode_fn(params, {"inputs": inp}, cache, P + i)
        logits = T.gather_logits(logits, ctx)
        if keep_logits:
            kept.append(logits)
        tok = _all_rows(_next_token(logits, temperature, generator), ctx, B)
        out.append(tok)
    toks = torch.stack(out, dim=1)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    timings = {"prefill_s": t_prefill, "decode_s": t_decode, "cache": cache}
    if keep_logits:
        timings["logits"] = kept
    return toks, timings


def _prompts(cfg, B: int, P: int, dev):
    rng = np.random.default_rng(0)
    if cfg.embed_input:
        prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, P)))
    else:
        prompts = torch.from_numpy(
            rng.standard_normal((B, P, cfg.d_model)).astype(np.float32))
    return prompts.to(dev)


def _config(opts: dict) -> ModelConfig:
    from .. import configs
    cfg = (configs.get_smoke_config(opts["arch"]) if opts["smoke"]
           else configs.get_config(opts["arch"]))
    if opts["layers"] is not None:
        cfg = dataclasses.replace(cfg, n_layers=opts["layers"])
    return cfg


def _serve(opts: dict, dev, ctx=None):
    """The CLI's run: the model drawn from seed 0 on ``dev`` (with ``ctx``,
    the rank's blocks of it), its prompts, :func:`generate`."""
    cfg = _config(opts)
    params = T.init_params(0, cfg, device=dev)
    if ctx is not None:
        from ..convert import shard_lm_params
        params = shard_lm_params(params, cfg, ctx)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.inference_mode():
        return generate(params, cfg, _prompts(cfg, opts["batch"],
                                              opts["prompt_len"], dev),
                        opts["gen"], temperature=opts["temperature"],
                        generator=gen, ctx=ctx)


def serve_rank(rank: int, world: int, opts: dict) -> dict:
    """Rank body of ``--mesh DxM`` (``launch.mesh.spawn_ranks``): the
    CLI's run on this rank's blocks.  Returns the tokens, the timings
    and the mesh's transport."""
    from ..distributed.sharding import make_ctx
    from .mesh import make_test_mesh
    mesh = make_test_mesh(*opts["mesh"], device=opts["device"])
    toks, t = _serve(opts, mesh.device, make_ctx(mesh))
    return {"tokens": toks.cpu().numpy(), "transport": mesh.describe(),
            "prefill_s": t["prefill_s"], "decode_s": t["decode_s"]}


def _mesh_shape(text: str):
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh takes DxM (data x model ranks), got {text!r}") from None
    if d < 1 or m < 1:
        raise argparse.ArgumentTypeError(f"--mesh {text!r}: sizes >= 1")
    return d, m


def main(argv=None) -> int:
    from .._device import resolve_device
    from .mesh import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_5_32b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (tests)")
    ap.add_argument("--mesh", type=_mesh_shape, default=None,
                    help="DxM: serve on a (data, model) mesh of D x M "
                         "ranks, one process each")
    opts = vars(ap.parse_args(argv))

    if opts["mesh"] is None:
        dev = resolve_device(opts["device"])
        toks, t = _serve(opts, dev)
        toks, where = toks.cpu().numpy(), str(dev)
    else:
        d, m = opts["mesh"]
        out = spawn_ranks(serve_rank, d * m, opts, timeout=MESH_TIMEOUT,
                          device=opts["device"])[0]
        toks, t, where = out["tokens"], out, out["transport"]
    B, P, G = opts["batch"], opts["prompt_len"], opts["gen"]
    print(f"prefill {P} toks x{B}: {t['prefill_s'] * 1e3:.1f} ms;  "
          f"decode {G - 1} steps: {t['decode_s'] * 1e3:.1f} ms "
          f"({B * (G - 1) / max(t['decode_s'], 1e-9):.1f} tok/s) "
          f"on {where}")
    print("sampled token ids:\n", toks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
