"""Model zoo dispatch: `init_model(name)` resolves the MODEL config key
(default deepfilternet3) and returns (params, state, cfg, module), where
module exposes `streaming_init` and `streaming_cell`.

Only DeepFilterNet3 is ported; the other families are ROADMAP item 9.
`dfnet3_fused` holds its dense-folded streaming cell (`build_fused`,
`FusedDfNet3`).
"""

from __future__ import annotations

import importlib
from typing import Optional

import torch

from deepfilternet_torch.config import config

_MODEL_MODULES = {
    "deepfilternet3": ("deepfilternet_torch.models.dfnet3", "init_dfnet3", "ModelParams3"),
}
_NOT_PORTED = ("deepfilternet2", "deepfilternet", "deepfilternetmf")


def model_module(name: Optional[str] = None):
    name = (name or config("MODEL", default="deepfilternet3", section="train")).lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP: other model families)"
        )
    if name not in _MODEL_MODULES:
        raise ValueError(f"Unknown model {name!r}; available: {sorted(_MODEL_MODULES)}")
    mod_name, init_name, params_name = _MODEL_MODULES[name]
    mod = importlib.import_module(mod_name)
    return mod, getattr(mod, init_name), getattr(mod, params_name)


def init_model(name: Optional[str] = None, seed: int = 42, device="cpu"):
    """Random weights from a torch generator seeded with `seed`."""
    mod, init_fn, _ = model_module(name)
    params, state, cfg = init_fn(torch.Generator().manual_seed(seed), device=device)
    return params, state, cfg, mod
