"""LM serving: prefill + decode step factories and a batched-request CLI.

    python -m repro_torch.launch.serve --arch qwen2_5_32b --batch 4 \\
        --prompt-len 1024 --gen 32 --temperature 0
    python -m repro_torch.launch.serve --smoke --device cpu --temperature 0

Runs on the card (``--device`` defaults to ``cuda``).  Unlike the JAX
package's CLI, whose ``make_prefill`` defaults to ``impl="xla"``, the
port's prefill defaults to ``impl="pallas"``: on the card every layer's
prefill attention is the CUDA flash kernel (ROADMAP Queue 3 lists the
difference).  The matrix-completion serving CLI is
:mod:`repro_torch.launch.serve_mc`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..models import transformer as T
from ..models.attention import KVCache
from ..models.config import ModelConfig


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


def _merge_prefill_cache(full_cache, pre_cache, cfg, P):
    """Write the prefill's KV (length ``P``) into the zero-initialised
    full-length caches, in place; an SSM layer's state carries over
    unchanged (its slot in the list is replaced).  Returns the list."""
    for i, (dst, src) in enumerate(zip(full_cache, pre_cache)):
        if isinstance(dst, KVCache):
            dst.k[:, :P] = src.k.to(dst.k.dtype)
            dst.v[:, :P] = src.v.to(dst.v.dtype)
        else:
            full_cache[i] = src
    return full_cache


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _next_token(logits, temperature: float, generator):
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def generate(params, cfg: ModelConfig, prompts, gen: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None):
    """Serve one batch as the CLI does: prefill ``prompts`` (B, P), move
    its KV into caches of the ``P + gen - 1`` positions decode writes,
    take the first token from the prefill's logits (greedy) and then
    ``gen - 1`` decode steps, each sampling at ``temperature`` (0 =
    greedy) from ``generator``.  Returns ``(tokens (B, gen), timings)``
    with ``prefill_s`` (prefill and merge) and ``decode_s``, each ended
    by a device synchronisation."""
    B, P = prompts.shape[:2]
    dev = prompts.device
    prefill_fn = make_prefill(cfg)
    decode_fn = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, pre_cache = prefill_fn(params, {"inputs": prompts})
    cache = T.init_cache(cfg, B, P + gen - 1, device=dev,
                         dtype=params.dtype)
    cache = _merge_prefill_cache(cache, pre_cache, cfg, P)
    del pre_cache
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    eye = torch.arange(cfg.d_model, device=dev)
    t0 = time.perf_counter()
    for i in range(gen - 1):
        inp = (tok[:, None] if cfg.embed_input
               else (tok[:, None] == eye).to(params.dtype)[:, None])
        logits, cache = decode_fn(params, {"inputs": inp}, cache, P + i)
        tok = _next_token(logits, temperature, generator)
        out.append(tok)
    toks = torch.stack(out, dim=1)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return toks, {"prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None) -> int:
    from .. import configs
    from .._device import resolve_device

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
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = resolve_device(args.device)
    B, P, G = args.batch, args.prompt_len, args.gen

    params = T.init_params(0, cfg, device=dev)
    rng = np.random.default_rng(0)
    if cfg.embed_input:
        prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, P)))
    else:
        prompts = torch.from_numpy(
            rng.standard_normal((B, P, cfg.d_model)).astype(np.float32))
    prompts = prompts.to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.inference_mode():
        toks, t = generate(params, cfg, prompts, G,
                           temperature=args.temperature, generator=gen)
    print(f"prefill {P} toks x{B}: {t['prefill_s'] * 1e3:.1f} ms;  "
          f"decode {G - 1} steps: {t['decode_s'] * 1e3:.1f} ms "
          f"({B * (G - 1) / max(t['decode_s'], 1e-9):.1f} tok/s) "
          f"on {dev}")
    print("sampled token ids:\n", toks.cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
