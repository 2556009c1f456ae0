"""Batched serving engine: prompt ingestion + greedy decode over a KV/SSM
cache.

Dense, moe and vlm prompts go through the backbone in one forward pass
that collects each layer's k/v (the attention of every layer through
``cfg.attn_impl``, on the card the flash-attention kernel); an encdec
prompt goes through the encoder and the decoder in one pass that keeps
each layer's cross-attention k/v (its self-attention cache stays
unfilled, as in the reference).  vlm patches and encdec frames come in
through ``extras``.  SSM and hybrid prompts replay through the single-token recurrence, one
``decode_step`` per prompt position from a fresh cache, as the
reference's ``_ingest_recurrent`` does: the full-sequence pass keeps no
final states.  Then each new token is one decode step that writes the
cache in place.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import (ModelConfig, decode_step, init_cache,
                                prefill)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_seq: int,
                 batch: int, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch = batch
        self.device = resolve_device(device)

    def _ingest_recurrent(self, tokens):
        """(last-position logits (B, V), cache filled to the prompt)."""
        cache = init_cache(self.cfg, tokens.shape[0], self.max_seq,
                           device=self.device)
        for t in range(tokens.shape[1]):
            lg, cache = decode_step(self.cfg, self.params, cache,
                                    tokens[:, t:t + 1], t)
        return lg[:, 0], cache

    def generate(self, tokens, *, max_new_tokens: int,
                 extras: dict | None = None) -> np.ndarray:
        """Greedy continuation of ``tokens`` (B, prompt_len): int32
        (B, max_new_tokens) on the host.  ``extras`` (arrays or tensors:
        ``frames`` for encdec, ``patches`` for vlm) join the prefill's
        inputs beside the tokens on the attention path, on the engine's
        device, as in the reference; the recurrent ingest does not read
        them."""
        cfg = self.cfg
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                 device=self.device)
        plen = tokens.shape[1]
        with torch.inference_mode():
            if cfg.family in ("ssm", "hybrid"):
                last_logits, cache = self._ingest_recurrent(tokens)
            else:
                inputs = {"tokens": tokens, **{
                    key: torch.as_tensor(val, device=self.device)
                    for key, val in (extras or {}).items()}}
                lg, cache = prefill(cfg, self.params, inputs,
                                    max_seq=self.max_seq)
                last_logits = lg[:, -1]
            out = [torch.argmax(last_logits, dim=-1)]
            pos = plen
            for _ in range(max_new_tokens - 1):
                lg, cache = decode_step(cfg, self.params, cache,
                                        out[-1][:, None], pos)
                out.append(torch.argmax(lg[:, 0], dim=-1))
                pos += 1
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
