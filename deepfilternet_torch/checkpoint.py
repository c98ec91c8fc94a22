"""Checkpoints, and weight transfer into PyTorch tensors.

Both packages store checkpoints as pickles of numpy trees
(`model_<epoch>.ckpt` files under a checkpoint directory, and a
`model_<epoch>.ckpt.best` copy of a best epoch: the reference's layout,
df/checkpoint.py:21-188): "params", "state", "epoch",
"extra" and, when given, "opt_state". `write_cp` writes that format (the
port's opt_state is a numpy tree of a torch optimizer's `state_dict()`),
keeps the newest `keep_n` files and one best; `log_best`, `read_best` and
`check_patience` keep the `.best` history and the `.patience` count.

A JAX checkpoint pickles its optimizer state with classes from `optax`,
which the port neither has nor needs: `read_cp` unpickles with a
`find_class` that turns every `optax.*` class into an inert stub and keeps
"opt_state" only when it is a torch optimizer's (restore it with
`optimizer_state_from_numpy`). `params_from_numpy` turns the numpy trees
into tensor trees on a device, in the same nesting (dicts and lists) the
JAX layers index.

The converters (`convert_dfn3_state_dict`, `convert_dfn2_state_dict`,
`convert_dfn1_state_dict`) turn a reference DeepFilterNet `state_dict()`
(torch tensors or numpy arrays, as `load_torch_checkpoint` reads them) into
(params, state) numpy trees of the same form as `read_cp`'s payload.
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


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def write_cp(
    ckpt_dir: str,
    params: Any,
    state: Any,
    epoch: int,
    opt_state: Any = None,
    is_best: bool = False,
    keep_n: int = 3,
    extra: Optional[Dict] = None,
) -> str:
    """Write `model_<epoch>.ckpt` (tensors as numpy arrays; pass an
    optimizer's `state_dict()` as opt_state) and, for a best epoch, the same
    bytes as `model_<epoch>.ckpt.best`, as the reference does; then
    `_cleanup`. So `read_cp(..., "latest")` finds every epoch written, best
    or not. Returns the path of the plain file."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "params": _to_numpy(params),
        "state": _to_numpy(state),
        "epoch": epoch,
        "extra": extra or {},
    }
    if opt_state is not None:
        payload["opt_state"] = _to_numpy(opt_state)
    path = os.path.join(ckpt_dir, f"model_{epoch}.ckpt")
    data = pickle.dumps(payload)
    for name in (path, path + ".best") if is_best else (path,):
        with open(name, "wb") as f:
            f.write(data)
    _cleanup(ckpt_dir, keep_n)
    return path


def _cleanup(ckpt_dir: str, keep_n: int):
    """Keep the newest `keep_n` checkpoints (all for keep_n <= 0) and the
    newest best one."""
    cps = [c for c in _list_cps(ckpt_dir) if not c[1]]
    for _, _, path in cps[:-keep_n] if keep_n > 0 else []:
        os.remove(path)
    best = [c for c in _list_cps(ckpt_dir) if c[1]]
    for _, _, path in best[:-1]:
        os.remove(path)


def read_cp(ckpt_dir: str, which: str | int = "latest") -> Optional[Dict]:
    """Load a checkpoint; which: 'best' | 'latest' | epoch int.

    Returns {"params", "state", "epoch", "extra"} with numpy trees, and
    "opt_state" when the file holds a torch optimizer's; None when the
    directory holds no checkpoint.
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
    opt_state = payload.pop("opt_state", None)
    if isinstance(opt_state, dict) and "param_groups" in opt_state:
        payload["opt_state"] = opt_state
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


def optimizer_state_from_numpy(opt_state):
    """`read_cp`'s "opt_state" -> the state dict a torch optimizer's
    `load_state_dict` takes (it moves the tensors to its parameters): the
    arrays become tensors, the other values stay."""
    if isinstance(opt_state, dict):
        return {k: optimizer_state_from_numpy(v) for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)):
        return type(opt_state)(optimizer_state_from_numpy(v) for v in opt_state)
    if isinstance(opt_state, np.ndarray):
        return torch.from_numpy(np.array(opt_state, copy=True))
    return opt_state


# -- best-metric and patience bookkeeping (df/checkpoint.py:119-188) ----------


def log_best(ckpt_dir: str, epoch: int, metric: float):
    with open(os.path.join(ckpt_dir, ".best"), "a") as f:
        f.write(f"{epoch} {metric}\n")


def read_best(ckpt_dir: str) -> Optional[Tuple[int, float]]:
    """The last (epoch, metric) `log_best` wrote, or None."""
    path = os.path.join(ckpt_dir, ".best")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        lines = [ln.split() for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        return None
    ep, met = lines[-1]
    return int(ep), float(met)


def check_patience(ckpt_dir: str, max_patience: int, new_metric: float,
                   maximize: bool = True) -> bool:
    """True while training should go on: counts consecutive epochs whose
    metric does not beat the last best in a `.patience` file."""
    path = os.path.join(ckpt_dir, ".patience")
    best = read_best(ckpt_dir)
    improved = best is None or (new_metric > best[1] if maximize else new_metric < best[1])
    if improved:
        count = 0
    else:
        count = 1
        if os.path.isfile(path):
            with open(path) as f:
                count += int(f.read().strip())
    with open(path, "w") as f:
        f.write(str(count))
    return count < max_patience


# ---------------------------------------------------------------------------
# reference state dicts -> parameter trees
# ---------------------------------------------------------------------------

# our name -> the reference module path inside DfNet; DFN2 and DFN1 keep
# DFN3's module paths for their conv blocks
_DFN3_CONV_MAP = {
    "erb_conv0": "enc.erb_conv0",
    "erb_conv1": "enc.erb_conv1",
    "erb_conv2": "enc.erb_conv2",
    "erb_conv3": "enc.erb_conv3",
    "df_conv0": "enc.df_conv0",
    "df_conv1": "enc.df_conv1",
    "conv3p": "erb_dec.conv3p",
    "convt3": "erb_dec.convt3",
    "conv2p": "erb_dec.conv2p",
    "convt2": "erb_dec.convt2",
    "conv1p": "erb_dec.conv1p",
    "convt1": "erb_dec.convt1",
    "conv0p": "erb_dec.conv0p",
    "conv0_out": "erb_dec.conv0_out",
    "df_convp": "df_dec.df_convp",
}
_DFN2_CONV_MAP = _DFN3_CONV_MAP
_DFN1_CONV_MAP = _DFN3_CONV_MAP

_DFN3_GRU_MAP = {
    "enc_emb_gru": "enc.emb_gru",
    "dec_emb_gru": "erb_dec.emb_gru",
    "df_gru": "df_dec.df_gru",
}


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _numpy_sd(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
            for k, v in sd.items()}


def _convert_conv_block(sd: Dict[str, np.ndarray], prefix: str) -> Tuple[Dict, Dict]:
    """A reference conv block's tensors, told apart by shape (this covers
    the index-keyed Conv2dNormAct sequences of DFN2/3 and the name-keyed
    convkxf ones of DFN1): the pointwise conv is the square [O, O, 1, 1], the
    main (grouped or transposed) conv the other 4-D weight, batch norm the
    tensors beside running statistics."""
    keys = sorted(
        (k for k in sd if k.startswith(prefix + ".")),
        key=lambda k: [int(p) if p.isdigit() else p for p in k.split(".")],
    )
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    convs = [k for k in keys if k.endswith(".weight") and sd[k].ndim == 4]
    if not convs:
        raise KeyError(f"No conv weights under {prefix}")
    if len(convs) == 1:
        main, pw = convs[0], None
    else:
        if len(convs) != 2:
            raise ValueError(f"{prefix}: expected at most 2 conv weights, got {convs}")
        sq = [k for k in convs
              if sd[k].shape[0] == sd[k].shape[1] and sd[k].shape[2:] == (1, 1)]
        if not sq:
            raise ValueError(f"{prefix}: cannot identify the pointwise conv")
        pw = sq[-1]
        main = convs[0] if pw == convs[1] else convs[1]
    params["w"] = _f32(sd[main])
    if pw is not None:
        params["pw"] = _f32(sd[pw])
    for k in keys:
        # a conv's bias (batch norm's is read below)
        if (k.endswith(".bias") and sd[k].ndim == 1
                and k.replace(".bias", ".running_mean") not in sd
                and k.replace(".bias", ".weight") in convs):
            params["b"] = _f32(sd[k])
    bn_means = [k for k in keys if k.endswith(".running_mean")]
    if bn_means:
        base = bn_means[0].rsplit(".", 1)[0]
        params["bn"] = {"scale": _f32(sd[base + ".weight"]), "bias": _f32(sd[base + ".bias"])}
        state["bn"] = {"mean": _f32(sd[base + ".running_mean"]),
                       "var": _f32(sd[base + ".running_var"])}
    return params, state


def _convert_gru(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """A torch GRU stack: weight_ih_l{i} ... -> {"layers": [...]}."""
    layers = []
    li = 0
    while f"{prefix}.weight_ih_l{li}" in sd:
        layers.append({
            "w_ih": _f32(sd[f"{prefix}.weight_ih_l{li}"]),
            "w_hh": _f32(sd[f"{prefix}.weight_hh_l{li}"]),
            "b_ih": _f32(sd[f"{prefix}.bias_ih_l{li}"]),
            "b_hh": _f32(sd[f"{prefix}.bias_hh_l{li}"]),
        })
        li += 1
    if not layers:
        raise KeyError(f"No GRU weights under {prefix}")
    return {"layers": layers}


def _convert_squeezed_gru(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """SqueezedGRU(_S): linear_in.0, the GRU, linear_out.0, gru_skip."""
    out: Dict[str, Any] = {
        "linear_in": {"w": _f32(sd[f"{prefix}.linear_in.0.weight"])},
        "gru": _convert_gru(sd, f"{prefix}.gru"),
    }
    if f"{prefix}.linear_out.0.weight" in sd:
        out["linear_out"] = {"w": _f32(sd[f"{prefix}.linear_out.0.weight"])}
    if f"{prefix}.gru_skip.weight" in sd:
        out["skip"] = {"w": _f32(sd[f"{prefix}.gru_skip.weight"])}
    return out


def _convert_linear(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    out = {"w": _f32(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["b"] = _f32(sd[f"{prefix}.bias"])
    return out


def _convert_grouped_linear_shuffle(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """GroupedLinear: a torch Linear a group at `{prefix}.layers.{i}`."""
    layers = []
    i = 0
    while f"{prefix}.layers.{i}.weight" in sd:
        layers.append(_convert_linear(sd, f"{prefix}.layers.{i}"))
        i += 1
    if not layers:
        raise KeyError(f"No GroupedLinear weights under {prefix}")
    return {"layers": layers}


def _convert_grouped_gru(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """GroupedGRU: a GroupedGRULayer a layer at `{prefix}.grus.{li}`, each
    holding a one-layer torch GRU a group at `.layers.{gi}`."""
    layers = []
    li = 0
    while f"{prefix}.grus.{li}.layers.0.weight_ih_l0" in sd:
        gs = []
        gi = 0
        while f"{prefix}.grus.{li}.layers.{gi}.weight_ih_l0" in sd:
            gs.append(_convert_gru(sd, f"{prefix}.grus.{li}.layers.{gi}"))
            gi += 1
        layers.append(gs)
        li += 1
    if not layers:
        raise KeyError(f"No GroupedGRU weights under {prefix}")
    return {"layers": layers}


def _convert_convs(sd, conv_map, params, state):
    for ours, theirs in conv_map.items():
        p, s = _convert_conv_block(sd, theirs)
        params[ours] = p
        if s:
            state[ours] = s


def convert_dfn3_state_dict(sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """A reference DeepFilterNet3 `DfNet.state_dict()` -> (params, state)
    for models.dfnet3. Buffers this package rebuilds itself (erb_fb,
    erb_inv_fb, the DF op's pads) are ignored."""
    sd = _numpy_sd(sd)
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    _convert_convs(sd, _DFN3_CONV_MAP, params, state)
    for ours, theirs in _DFN3_GRU_MAP.items():
        params[ours] = _convert_squeezed_gru(sd, theirs)
    params["df_fc_emb"] = {"w": _f32(sd["enc.df_fc_emb.0.weight"])}
    params["lsnr_fc"] = _convert_linear(sd, "enc.lsnr_fc.0")
    params["df_out"] = {"w": _f32(sd["df_dec.df_out.0.weight"])}
    params["df_fc_a"] = _convert_linear(sd, "df_dec.df_fc_a.0")
    if "df_dec.df_skip.weight" in sd:
        params["df_skip"] = {"w": _f32(sd["df_dec.df_skip.weight"])}
    return params, state


def convert_dfn2_state_dict(sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """A reference DeepFilterNet2 `DfNet.state_dict()` -> (params, state)
    for models.dfnet2, either gru_type: "grouped" (GroupedGRU/GroupedLinear)
    or "squeeze" (SqueezedGRU/GroupedLinearEinsum), told apart by the keys."""
    sd = _numpy_sd(sd)
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    _convert_convs(sd, _DFN2_CONV_MAP, params, state)
    if "enc.emb_gru.grus.0.layers.0.weight_ih_l0" in sd:
        params["df_fc_emb"] = _convert_grouped_linear_shuffle(sd, "enc.df_fc_emb")
        params["enc_emb_gru"] = _convert_grouped_gru(sd, "enc.emb_gru")
        params["dec_emb_gru"] = _convert_grouped_gru(sd, "erb_dec.emb_gru")
        params["dec_fc_emb"] = _convert_grouped_linear_shuffle(sd, "erb_dec.fc_emb.0")
        params["df_gru"] = _convert_grouped_gru(sd, "df_dec.df_gru")
    else:
        params["df_fc_emb"] = {"w": _f32(sd["enc.df_fc_emb.0.weight"])}
        for ours, theirs in _DFN3_GRU_MAP.items():
            params[ours] = _convert_squeezed_gru(sd, theirs)
    params["lsnr_fc"] = _convert_linear(sd, "enc.lsnr_fc.0")
    params["df_out"] = _convert_linear(sd, "df_dec.df_out.0")
    params["df_fc_a"] = _convert_linear(sd, "df_dec.df_fc_a.0")
    if "df_dec.df_skip.weight" in sd:
        params["df_skip"] = {"w": _f32(sd["df_dec.df_skip.weight"])}
    return params, state


def convert_dfn1_state_dict(sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """A reference DeepFilterNet (v1) `DfNet.state_dict()` (convkxf blocks,
    GroupedGRU/GroupedLinear heads) -> (params, state) for models.dfnet1."""
    sd = _numpy_sd(sd)
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    _convert_convs(sd, _DFN1_CONV_MAP, params, state)
    params["df_fc_emb"] = _convert_grouped_linear_shuffle(sd, "enc.df_fc_emb")
    params["enc_emb_gru"] = _convert_grouped_gru(sd, "enc.emb_gru")
    params["lsnr_fc"] = _convert_linear(sd, "enc.lsnr_fc.0")
    params["dec_fc_emb"] = _convert_grouped_linear_shuffle(sd, "erb_dec.fc_emb.0")
    params["df_gru"] = _convert_grouped_gru(sd, "df_dec.df_gru")
    params["df_out"] = _convert_linear(sd, "df_dec.df_fc_out.0")
    params["df_fc_a"] = _convert_linear(sd, "df_dec.df_fc_a.0")
    return params, state


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint file (a state dict, or a dict holding one under
    "state_dict") -> a numpy state dict of its tensors. The file is
    unpickled in full (`weights_only=False`): load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items() if hasattr(v, "detach")}
