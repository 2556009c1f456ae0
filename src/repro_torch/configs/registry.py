"""Architecture registry: a name or alias resolves to its ``ModelConfig``.

The same ten configurations, names and aliases as the reference
package.  Every config resolves; serving runs only the ``dense`` family
so far (:mod:`repro_torch.models` raises ``NotImplementedError`` for
the others).
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
