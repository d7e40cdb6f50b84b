"""Serving entry point: prefill a batch of prompts, decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --batch 4 --prompt-len 512 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --layers 4 --dtype float32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --layers 8

Port of ``repro.launch.serve`` for every preset of
``repro_torch.configs.ARCHS``.  It runs on ``cuda`` unless ``--device``
says otherwise, and raises without a CUDA device; on the card each
decode step's attention is the ``flash_decode`` kernel at every
attention layer.  Weights are random from seed 0
(``transformer.init_params``, drawn on the device), prompts from
``numpy.random.default_rng(0)`` as in the reference: ``[B, prompt_len]``
token ids, ``[B, prompt_len, K]`` for audio, and for vision also
``[B, num_patches, frontend_dim]`` float32 patch embeddings drawn after
the ids.  As in the reference's entry point, decoding starts from the
prefill's ``argmax`` at position ``prompt_len + num_patches``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.driver import resolve_device
from repro_torch.models import transformer
from repro_torch.sharding.specs import unsharded_ctx
from repro_torch.train.serve import make_serve_step


@dataclasses.dataclass
class ServeRun:
    """What one serving run leaves: its inputs and state, for a
    caller that replays the decode (a plain twin) or checks it."""

    cfg: ModelConfig
    params: dict
    cache: tuple  # after the last step (written in place)
    prompt: np.ndarray  # [B, prompt_len] (or [B, prompt_len, K] audio)
    pos0: int  # position of the first decode step
    inputs: torch.Tensor  # [B, gen] (or [B, gen, K]) int32: the token each step was fed
    tokens: np.ndarray  # [B, gen] (or [B, gen, K]): the token each step chose
    logits: list[torch.Tensor]  # gen x [B, (K,) V] float32, each step's logits
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> ServeRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                    help="the weights' and activations' dtype (default: the preset's)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    device = resolve_device(args.device)
    ctx = unsharded_ctx()
    params = transformer.init_params(cfg, 0, device, tp=1)
    rng = np.random.default_rng(0)
    patches = cfg.num_patches if cfg.modality == "vision" else 0
    max_len = args.prompt_len + args.gen + patches
    shape = (args.batch, args.prompt_len)
    if cfg.modality == "audio-codec":
        shape += (cfg.num_codebooks,)
    prompt = rng.integers(0, cfg.vocab_size, size=shape)
    batch = {"tokens": torch.from_numpy(prompt).to(device)}
    if cfg.modality == "vision":
        embeds = rng.normal(0, 1, size=(args.batch, cfg.num_patches, cfg.frontend_dim))
        batch["patch_embeds"] = torch.from_numpy(embeds.astype(np.float32)).to(device)

    _sync(device)
    t0 = time.perf_counter()
    last_logits, cache = transformer.prefill(params, cfg, batch, max_len, ctx)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    serve_step = make_serve_step(cfg, ctx)
    pos0 = args.prompt_len + patches
    tok = torch.argmax(last_logits, dim=-1).to(torch.int32)  # [B, 1] (or [B, 1, K])
    fed, chosen, logits = [], [], []
    t0 = time.perf_counter()
    for i in range(args.gen):
        fed.append(tok)
        tok, step_logits, cache = serve_step(params, cache, tok, pos0 + i)
        chosen.append(tok)
        logits.append(step_logits[:, 0])
    tokens = torch.cat(chosen, dim=1).cpu().numpy()  # waits for the last step
    decode_s = time.perf_counter() - t0
    return ServeRun(cfg, params, cache, prompt, pos0, torch.cat(fed, dim=1),
                    tokens, logits, prefill_s, decode_s)


def main(argv=None) -> np.ndarray:
    r = run(argv)
    b, gen = r.tokens.shape[:2]
    print(f"prefill: {b}x{r.prompt.shape[1]} in {r.prefill_s:.2f}s")
    print(f"decode: {gen} steps x batch {b} in {r.decode_s:.2f}s "
          f"({r.decode_s / gen * 1000:.1f} ms/token)")
    print("generated ids (first request):", r.tokens[0].flatten()[:24].tolist())
    return r.tokens


if __name__ == "__main__":
    main()
