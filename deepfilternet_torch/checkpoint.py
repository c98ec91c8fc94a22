"""Checkpoint reading and weight transfer into PyTorch tensors.

The JAX package stores checkpoints as pickles of numpy parameter/state trees
(`model_<epoch>.ckpt[.best]` files under a checkpoint directory). The payload
also pickles the optimizer state, whose classes live in `optax`; the port
neither has nor needs it. `read_cp` therefore unpickles with a `find_class`
that turns every `optax.*` class into an inert stub, and drops `opt_state`
from the payload. `params_from_numpy` turns the numpy trees into tensor trees
on a device, in the same nesting (dicts and lists) the JAX layers index.
"""

from __future__ import annotations

import importlib
import os
import pickle
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

CKPT_RE = re.compile(r"^model_(\d+)\.ckpt(\.best)?$")


class _OptaxStub:
    """Stands in for any optax state class while unpickling; holds nothing."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "optax" or module.startswith("optax."):
            return type(name, (_OptaxStub,), {})
        if module.startswith("numpy._core"):
            # pickles written by numpy >= 2 name `numpy._core`; numpy 1.x
            # keeps the same objects under `numpy.core`
            try:
                importlib.import_module(module)
            except ModuleNotFoundError:
                module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def _list_cps(ckpt_dir: str) -> List[Tuple[int, bool, str]]:
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        m = CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), m.group(2) is not None, os.path.join(ckpt_dir, name)))
    return sorted(out)


def read_cp(ckpt_dir: str, which: str | int = "latest") -> Optional[Dict]:
    """Load a checkpoint; which: 'best' | 'latest' | epoch int.

    Returns {"params", "state", "epoch", "extra"} with numpy trees, or None
    when the directory holds no checkpoint.
    """
    cps = _list_cps(ckpt_dir)
    if not cps:
        return None
    if which == "best":
        best = [c for c in cps if c[1]]
        target = best[-1] if best else cps[-1]
    elif which == "latest":
        non_best = [c for c in cps if not c[1]] or cps
        target = non_best[-1]
    else:
        matching = [c for c in cps if c[0] == int(which)]
        if not matching:
            raise FileNotFoundError(f"No checkpoint for epoch {which} in {ckpt_dir}")
        target = matching[-1]
    with open(target[2], "rb") as f:
        payload = _CheckpointUnpickler(f).load()
    payload.pop("opt_state", None)
    return payload


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_from_numpy(params: Any, state: Any, device) -> Tuple[Any, Any]:
    """Numpy parameter and state trees (as `read_cp` or the JAX package's
    `init_dfnet3` give them) -> the same trees of tensors on `device`."""
    return _to_torch(params, device), _to_torch(state, device)
