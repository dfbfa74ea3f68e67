"""Serving steps: decode one token per call against the KV cache, and
the host loop of greedy decoding.  The port of
`repro.serve.serve_step`; the cache is one device's (no sharding)."""
from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.lm import LM


def make_serve_step(model: LM):
    """Returns serve_step(cache, tokens, position[, image_embeds]) ->
    (next (B, 1) int64, cache): one decode step and its greedy pick.
    Ties go to the first maximum, as `jnp.argmax` does."""

    def serve_step(cache, tokens, position, image_embeds=None):
        logits, cache = model.decode_step(cache, tokens, position,
                                          image_embeds=image_embeds)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache

    return serve_step


def greedy_decode(model: LM, prompt_tokens, n_steps: int,
                  max_seq: int | None = None,
                  device=DEFAULT_DEVICE,
                  image_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Host-loop greedy decoding: step through the prompt (teacher
    forcing), then `n_steps` decode steps.  `prompt_tokens` (B, S) as a
    tensor or array; `device` must be the model's; `image_embeds` (B,
    n_image_tokens, D) on it for the VLM.  Returns the (B, S + n_steps)
    tokens on that device."""
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"greedy_decode on {dev}, model on {model.device}")
    if not isinstance(prompt_tokens, torch.Tensor):
        prompt_tokens = torch.from_numpy(np.asarray(prompt_tokens))
    prompt_tokens = prompt_tokens.to(dev, torch.int64)
    b, s = prompt_tokens.shape
    max_seq = max_seq or (s + n_steps)
    cache = model.init_cache(b, max_seq)
    step = make_serve_step(model)

    # prefill by stepping through the prompt (small-scale path; the
    # production prefill is `model.prefill`)
    tok = prompt_tokens[:, :1]
    out = [tok]
    for pos in range(max_seq - 1):
        if pos + 1 < s:
            _, cache = step(cache, tok, pos, image_embeds)
            tok = prompt_tokens[:, pos + 1:pos + 2]
        else:
            tok, cache = step(cache, tok, pos, image_embeds)
        out.append(tok)
        if pos + 1 >= s + n_steps - 1:
            break
    return torch.cat(out, dim=1)
