"""LM serving (port of the decode loop of ``repro.launch.serve``):
a batched prefill, then greedy decoding over a batch of synthetic prompts,
reporting the prefill time and decode tokens/s.

    python -m repro_torch.launch.serve --arch llama3.1-8b --reduced \
        --batch 4 --prompt-len 32 --gen 32 --device cuda|cpu

Every attention-only config of the zoo serves (``llama3.1-8b``,
``smolvlm``, ``smollm-135m``, ``qwen1.5-110b``, ``qwen2-72b``,
``mixtral-8x7b``, ``llama4-maverick-400b-a17b``), and ``jamba-v0.1-52b``
with its Mamba layers; the rest (MLA, cross-attention, the Whisper encoder,
xLSTM) is refused by name.  The reference's recommendation server
(``--recommend``) is not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.blocks import KV_TAIL


@dataclasses.dataclass
class Generation:
    tokens: np.ndarray          # [B, gen_tokens] int32, greedy
    prefill_logits: torch.Tensor   # [B, 1, V]: the prompt's last position
    t_prefill: float            # seconds, from inputs on the device ...
    t_decode: float             # ... to the result on the device

    @property
    def tok_s(self) -> float:
        B, n = self.tokens.shape
        return B * (n - 1) / max(self.t_decode, 1e-9)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def generate(params, cfg: ArchConfig, prompts: torch.Tensor,
             gen_tokens: int, ctx: Optional[torch.Tensor] = None
             ) -> Generation:
    """Prefill ``prompts`` [B, S], then ``gen_tokens - 1`` greedy decode
    steps over a cache of S + gen_tokens positions, merging the ring tails
    every ``KV_TAIL`` steps.  The clocks are read only after the device
    finished the work they time."""
    dev = prompts.device
    B, prompt_len = prompts.shape
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = lm.prefill(params, cfg, prompts, ctx)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    caches = lm.extend_caches(caches, cfg, prompt_len + gen_tokens)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(gen_tokens - 1):
        step_logits, caches = lm.decode_step(params, cfg, tok, caches,
                                             prompt_len + i)
        if (i + 1) % KV_TAIL == 0:     # amortised prefix merge
            caches = lm.flush_tails(caches, cfg)
        tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
    return Generation(tokens, logits, t_prefill, t_decode)


def inputs(cfg: ArchConfig, batch: int, prompt_len: int, seed: int,
           device) -> tuple:
    """Parameters, prompts and (for a prefix VLM) context embeddings from
    three separate streams of ``seed``, so that no draw repeats another."""
    dev = device_mod.resolve(device)
    params = lm.init_params(cfg, seed=3 * seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3 * seed + 1)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                            device=dev)
    ctx = None
    if cfg.n_context_tokens:
        gen = torch.Generator(device=dev).manual_seed(3 * seed + 2)
        ctx = (torch.randn((batch, cfg.n_context_tokens, cfg.d_model),
                           generator=gen, device=dev)
               * 0.1).to(L.dtype_of(cfg.param_dtype))
    return params, prompts, ctx


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen_tokens: int = 32, seed: int = 0,
          device="cuda"):
    """Greedy generation with random weights; returns (tokens, tok/s)."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    params, prompts, ctx = inputs(cfg, batch, prompt_len, seed, device)
    g = generate(params, cfg, prompts, gen_tokens, ctx)
    print(f"[serve] {arch}: prefill {prompt_len} tok x{batch} in "
          f"{g.t_prefill * 1e3:.0f} ms; decode {gen_tokens - 1} steps at "
          f"{g.tok_s:.1f} tok/s (batch={batch}, {device})")
    return g.tokens, g.tok_s


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    serve(a.arch, reduced=a.reduced, batch=a.batch, prompt_len=a.prompt_len,
          gen_tokens=a.gen, device=a.device)


if __name__ == "__main__":
    main()
