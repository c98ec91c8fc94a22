"""Model zoo dispatch: `init_model(name)` resolves the MODEL config key
(default deepfilternet3) and returns (params, state, cfg, module), where
module exposes `forward` and, but for DeepFilterNet-MF (offline only),
`streaming_init`, `streaming_cell`, `forward_chunk` and `RUNTIME_DTYPES`
(the model types the streaming runtimes take).

`dfnet3_fused` holds DFN3's dense-folded streaming cell (`build_fused`,
`FusedDfNet3`); `multiframe` the WF/MVDR filters of DeepFilterNet-MF.
"""

from __future__ import annotations

import importlib
from typing import Optional

import torch

from deepfilternet_torch.config import config

_MODEL_MODULES = {
    "deepfilternet3": ("deepfilternet_torch.models.dfnet3", "init_dfnet3", "ModelParams3"),
    "deepfilternet2": ("deepfilternet_torch.models.dfnet2", "init_dfnet2", "ModelParams2"),
    "deepfilternet": ("deepfilternet_torch.models.dfnet1", "init_dfnet1", "ModelParams1"),
    "deepfilternetmf": ("deepfilternet_torch.models.dfnetmf", "init_dfnetmf", "ModelParamsMF"),
}


def model_module(name: Optional[str] = None):
    name = (name or config("MODEL", default="deepfilternet3", section="train")).lower()
    if name not in _MODEL_MODULES:
        raise ValueError(f"Unknown model {name!r}; available: {sorted(_MODEL_MODULES)}")
    mod_name, init_name, params_name = _MODEL_MODULES[name]
    mod = importlib.import_module(mod_name)
    return mod, getattr(mod, init_name), getattr(mod, params_name)


def init_model(name: Optional[str] = None, seed: int = 42, device=None):
    """Random weights from a torch generator seeded with `seed`, on `device`
    (default: the CUDA device; raises when it is absent)."""
    from deepfilternet_torch.enhance import resolve_device

    mod, init_fn, _ = model_module(name)
    params, state, cfg = init_fn(torch.Generator().manual_seed(seed),
                                 device=resolve_device(device))
    return params, state, cfg, mod
