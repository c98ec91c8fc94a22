"""DeepFilterNet's layers as plain functions over parameter trees.

Each layer has two parts: a spec, which gives the shape of every weight and
the bound of its uniform draw (PyTorch's default initialisation, 1 /
sqrt(fan_in)), and an apply. The tree layout is that of DeepFilterNet's
checkpoints as the program loads them:

  * conv block: {"w": [O, I/g, kT, kF], "pw": [O, O, 1, 1] (optional),
    "bn": {"scale", "bias"}}, state {"bn": {"mean", "var"}};
  * transposed conv block: {"w": [I, O/g, kT, kF], ...};
  * linear {"w": [O, I], "b": [O]}; grouped linear {"w": [G, I/G, O/G]};
  * GRU {"layers": [{"w_ih", "w_hh", "b_ih", "b_hh"}]}, gates (r, z, n).

The convolutions are PyTorch's own `conv2d` and `conv_transpose2d`, as
DeepFilterNet's `Conv2dNormAct` and `ConvTranspose2dNormAct` call them,
and a GRU stack is one `torch.gru` call, what `torch.nn.GRU` runs.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class Leaf(NamedTuple):
    """A weight to draw: its shape and how ("uniform" in +-bound, "bn_scale",
    "bn_bias", "bn_mean", "bn_var")."""

    shape: Tuple[int, ...]
    kind: str = "uniform"
    bound: float = 0.0


def _u(shape, fan_in: int) -> Leaf:
    return Leaf(tuple(shape), "uniform", 1.0 / math.sqrt(fan_in))


# -- conv blocks --------------------------------------------------------------


def conv_spec(cin: int, cout: int, kernel, fstride: int = 1, act: str = "relu",
              transposed: bool = False):
    """A separable, bias-free conv block with batch norm (DeepFilterNet's
    `Conv2dNormAct(..., separable=True, bias=False)` and the transposed
    kind). Returns (params spec, state spec, static)."""
    kernel = tuple(kernel)
    groups = math.gcd(cin, cout)
    pw = groups > 1 and (transposed or max(kernel) > 1)
    if transposed:
        w = _u((cin, cout // groups) + kernel, (cout // groups) * kernel[0] * kernel[1])
    else:
        w = _u((cout, cin // groups) + kernel, (cin // groups) * kernel[0] * kernel[1])
    p = {"w": w, "bn": {"scale": Leaf((cout,), "bn_scale"), "bias": Leaf((cout,), "bn_bias")}}
    if pw:
        p["pw"] = _u((cout, cout, 1, 1), cout)
    st = {"bn": {"mean": Leaf((cout,), "bn_mean"), "var": Leaf((cout,), "bn_var")}}
    static = dict(kernel=kernel, fstride=fstride, groups=groups, act=act,
                  transposed=transposed, fpad=kernel[1] // 2)
    return p, st, static


ACT = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
       "identity": lambda x: x}


def batchnorm(p, st, x, train: bool):
    """Eval: running statistics. Train: the batch's mean and biased
    variance, and the new running statistics (momentum 0.1, unbiased)."""
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        with torch.no_grad():
            new = {"mean": 0.9 * st["mean"] + 0.1 * mean,
                   "var": 0.9 * st["var"] + 0.1 * var * n / max(n - 1, 1)}
    else:
        mean, var, new = st["mean"], st["var"], st
    inv = torch.rsqrt(var + 1e-5)
    out = (x - mean[None, :, None, None]) * inv[None, :, None, None]
    return out * p["scale"][None, :, None, None] + p["bias"][None, :, None, None], new


def conv_block(p, st, c, x: torch.Tensor, train: bool = False):
    """x [B, C, T, F] -> ([B, O, T, F'], new batch-norm state), causal in
    time (kT - 1 zero frames in front)."""
    kt, kf = c["kernel"]
    x = F.pad(x, (0, 0, kt - 1, 0))
    if c["transposed"]:
        out = F.conv_transpose2d(x, p["w"], stride=(1, c["fstride"]),
                                 padding=(kt - 1, c["fpad"]), output_padding=(0, c["fpad"]),
                                 groups=c["groups"])
    else:
        out = F.conv2d(x, p["w"], stride=(1, c["fstride"]), padding=(0, c["fpad"]),
                       groups=c["groups"])
    if "pw" in p:
        out = F.conv2d(out, p["pw"])
    out, bn = batchnorm(p["bn"], st["bn"], out, train)
    return ACT[c["act"]](out), {"bn": bn}


# -- linear layers ------------------------------------------------------------


def linear_spec(cin: int, cout: int):
    return {"w": _u((cout, cin), cin), "b": _u((cout,), cin)}


def linear(p, x):
    return x @ p["w"].T + p["b"]


def grouped_linear_spec(cin: int, cout: int, groups: int):
    return {"w": _u((groups, cin // groups, cout // groups), cin // groups)}


def grouped_linear(p, x):
    g, ws, hs = p["w"].shape
    out = torch.einsum("...gi,gih->...gh", x.reshape(x.shape[:-1] + (g, ws)), p["w"])
    return out.reshape(x.shape[:-1] + (g * hs,))


# -- GRU ----------------------------------------------------------------------


def gru_spec(cin: int, hidden: int, layers: int):
    b = 1.0 / math.sqrt(hidden)
    return {"layers": [{"w_ih": Leaf((3 * hidden, cin if i == 0 else hidden), "uniform", b),
                        "w_hh": Leaf((3 * hidden, hidden), "uniform", b),
                        "b_ih": Leaf((3 * hidden,), "uniform", b),
                        "b_hh": Leaf((3 * hidden,), "uniform", b)} for i in range(layers)]}


def gru(p, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """x [B, T, I], h0 [L, B, H] (zeros when None) -> (out [B, T, H], hN)."""
    layers = p["layers"]
    hidden = layers[0]["w_hh"].shape[1]
    if h0 is None:
        h0 = x.new_zeros((len(layers), x.shape[0], hidden))
    weights = [lp[k] for lp in layers for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    train = torch.is_grad_enabled() and any(
        w.requires_grad for w in weights + [x, h0])
    with warnings.catch_warnings():
        # the weights are separate tensors; the library copies them into one
        # buffer a call, which changes no result
        warnings.filterwarnings("ignore", message="RNN module weights")
        out, h = torch.gru(x.contiguous(), h0.contiguous(), weights, True, len(layers), 0.0,
                           train, False, True)
    return out, h


def squeezed_gru_spec(cin: int, hidden: int, out: Optional[int], layers: int, groups: int):
    p = {"linear_in": grouped_linear_spec(cin, hidden, groups),
         "gru": gru_spec(hidden, hidden, layers)}
    if out is not None:
        p["linear_out"] = grouped_linear_spec(hidden, out, groups)
    return p


def squeezed_gru_s(p, x, h0=None):
    """DFN3's SqueezedGRU_S (no skip): relu(linear_in) -> GRU ->
    relu(linear_out)."""
    out, h = gru(p["gru"], torch.relu(grouped_linear(p["linear_in"], x)), h0)
    if "linear_out" in p:
        out = torch.relu(grouped_linear(p["linear_out"], out))
    return out, h


def squeezed_gru_skip(p, x, h0=None):
    """DFN2's SqueezedGRU with the identity skip: xin = relu(linear_in(x)),
    GRU(xin) + xin, then relu(linear_out)."""
    xin = torch.relu(grouped_linear(p["linear_in"], x))
    out, h = gru(p["gru"], xin, h0)
    out = out + xin
    if "linear_out" in p:
        out = torch.relu(grouped_linear(p["linear_out"], out))
    return out, h


# -- weights ------------------------------------------------------------------


def leaves(tree, prefix=""):
    """(path, leaf) of a spec or tensor tree, in a fixed order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def unflatten(spec, values: Dict[str, torch.Tensor], prefix=""):
    if isinstance(spec, dict):
        return {k: unflatten(v, values, f"{prefix}{k}/") for k, v in spec.items()}
    if isinstance(spec, list):
        return [unflatten(v, values, f"{prefix}{i}/") for i, v in enumerate(spec)]
    return values[prefix.rstrip("/")]


# (low, high) of each batch-norm draw: the folds of a trained network, not
# the identity
BN_RANGES = {"bn_scale": (0.75, 1.25), "bn_bias": (-0.1, 0.1), "bn_mean": (-0.1, 0.1),
             "bn_var": (0.75, 1.25)}


def materialize(spec_trees, seed: int, device) -> list:
    """Every leaf of the spec trees drawn from one generator on `device`
    seeded with `seed`, in one call: uniform in +-bound, batch-norm leaves
    in BN_RANGES. Returns the trees of float32 tensors, in order."""
    flat = [(i, path, leaf) for i, t in enumerate(spec_trees) for path, leaf in leaves(t)]
    total = sum(math.prod(leaf.shape) for _, _, leaf in flat)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    values = [dict() for _ in spec_trees]
    lo = 0
    for i, path, leaf in flat:
        n = math.prod(leaf.shape)
        x = u[lo:lo + n].reshape(leaf.shape)
        lo += n
        if leaf.kind == "uniform":
            x = (2.0 * x - 1.0) * leaf.bound
        else:
            a, b = BN_RANGES[leaf.kind]
            x = a + (b - a) * x
        values[i][path] = x.contiguous()
    return [unflatten(t, v) for t, v in zip(spec_trees, values)]
