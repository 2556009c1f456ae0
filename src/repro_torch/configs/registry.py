"""Architecture registry: a name or alias resolves to its ``ModelConfig``.

The same ten configurations, names and aliases as the reference
package, in its six families: ``dense`` (yi-6b, gemma3-27b,
minitron-4b, gemma2-27b), ``moe`` (grok-1-314b, mixtral-8x22b), ``ssm``
(mamba2-2.7b), ``hybrid`` (zamba2-1.2b), ``encdec`` (whisper-small) and
``vlm`` (internvl2-26b).  Every config resolves and every family is
served (:mod:`repro_torch.models`, :class:`repro_torch.serve.ServeEngine`).
"""

from __future__ import annotations

import importlib

ARCHS = [
    "whisper_small",
    "yi_6b",
    "gemma3_27b",
    "minitron_4b",
    "gemma2_27b",
    "grok_1_314b",
    "mixtral_8x22b",
    "zamba2_1p2b",
    "mamba2_2p7b",
    "internvl2_26b",
]

_ALIASES = {
    "whisper-small": "whisper_small",
    "yi-6b": "yi_6b",
    "gemma3-27b": "gemma3_27b",
    "minitron-4b": "minitron_4b",
    "gemma2-27b": "gemma2_27b",
    "grok-1-314b": "grok_1_314b",
    "mixtral-8x22b": "mixtral_8x22b",
    "zamba2-1.2b": "zamba2_1p2b",
    "mamba2-2.7b": "mamba2_2p7b",
    "internvl2-26b": "internvl2_26b",
}


def get_config(name: str):
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCHS}
