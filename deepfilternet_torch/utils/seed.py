"""Seeding utilities (reference: df/utils.py check_manual_seed + util.rs),
the port's copy of `deepfilternet_tpu.utils.seed`.

A process-global seed gate mirroring the reference's "RNG errors unless
seeded" discipline (util.rs:55-62): call `seed_everything` once; helpers
derive deterministic per-purpose generators from it. `torch_generator` is
the port's counterpart of JAX's `jax_key`: an explicit `torch.Generator`,
never the global torch RNG.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

_GLOBAL_SEED: Optional[int] = None


def seed_everything(seed: int) -> int:
    global _GLOBAL_SEED
    _GLOBAL_SEED = int(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    return seed


def get_seed() -> int:
    if _GLOBAL_SEED is None:
        raise RuntimeError("seed_everything() must be called before using seeded RNGs")
    return _GLOBAL_SEED


def derive_rng(*stream: int) -> np.random.Generator:
    """Deterministic generator for a given purpose tuple."""
    return np.random.default_rng([get_seed(), *stream])


def torch_generator(*stream: int, device=None):
    """A `torch.Generator` on `device` (default: the CPU) seeded from
    `derive_rng(*stream)`: the same seed and stream give the same draws."""
    import torch

    seed = int(derive_rng(*stream).integers(0, 2**63 - 1))
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(seed)
    return gen
