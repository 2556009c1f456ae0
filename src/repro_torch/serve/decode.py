"""Batched serving engine: prefill + greedy decode over a KV cache.

The prompt goes through the backbone in one forward pass that collects
each layer's k/v (the attention of every layer through
``cfg.attn_impl``, on the card the flash-attention kernel), then each
new token is one decode step that writes the cache in place.  The dense
family only: the recurrent ingestion of ssm / hybrid prompts belongs to
a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, decode_step, prefill
from repro_torch.models.transformer import require_dense


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_seq: int,
                 batch: int, device="cuda"):
        require_dense(cfg, "ServeEngine")
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch = batch
        self.device = resolve_device(device)

    def generate(self, tokens, *, max_new_tokens: int) -> np.ndarray:
        """Greedy continuation of ``tokens`` (B, prompt_len): int32
        (B, max_new_tokens) on the host."""
        cfg = self.cfg
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                 device=self.device)
        plen = tokens.shape[1]
        with torch.inference_mode():
            last_logits, cache = prefill(cfg, self.params,
                                         {"tokens": tokens},
                                         max_seq=self.max_seq)
            out = [torch.argmax(last_logits[:, -1], dim=-1)]
            pos = plen
            for _ in range(max_new_tokens - 1):
                lg, cache = decode_step(cfg, self.params, cache,
                                        out[-1][:, None], pos)
                out.append(torch.argmax(lg[:, 0], dim=-1))
                pos += 1
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
