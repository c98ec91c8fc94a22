"""The DFN3 layers as plain functions on parameter trees of tensors.

Parameters keep the JAX package's tree layout, which is the reference torch
modules' layout, so the same checkpoint feeds both packages:

  * conv weight   [O, I/groups, kT, kF]   (+ optional pointwise [O, O, 1, 1])
  * convT weight  [I, O/groups, kT, kF]
  * linear weight [O, I], bias [O]
  * GRU per layer w_ih [3H, I], b_ih [3H], w_hh [3H, H], b_hh [3H]; gate
    order (reset, update, new), with b_hn inside r * (W_hn h + b_hn)
  * grouped linear weight [G, I/G, H/G]
  * batchnorm params scale/bias, state mean/var [C]

Two forms of each layer: `*_apply` over a whole [B, C, T, F] or [B, T, I]
sequence (causal time padding; a GRU stack is one `aten.gru` call, cuDNN on
the card), and `*_step` over one frame for the streaming cell, always in
inference mode (batchnorm reads its running statistics). The conv blocks'
`*_apply` take `train=True` for training: batchnorm then normalizes with
the batch's statistics and returns updated running statistics, as the JAX
layers do. A GRU runs in cuDNN's training mode whenever autograd needs its
backward.

DFN1 and DFN2 add the grouped layers: `GroupedLinear` with its channel
shuffle (params {"layers": [linear a group]}), `GroupedGRU` (a one-layer
GRU a group and layer, shuffled between layers, carry [L*G, B, H/G]) and
`SqueezedGRU`, whose skip feeds the GRU's input forward (the `_S` variant's
feeds its raw input).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# initializers (torch defaults), drawn from an explicit generator
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen)


def _kaiming_uniform(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    # kaiming_uniform_(a=sqrt(5)) => bound = 1/sqrt(fan_in)
    return _uniform(gen, shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic function. Below float32 it is written out as JAX lowers
    it, 1 / (1 + exp(-x)) rounded after each operation; torch.sigmoid rounds
    once, which moves a third of bfloat16 results by one unit in the last
    place and, through the GRU recurrences, the output by about 1%."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


@functools.lru_cache(maxsize=None)
def _rounded(c: float, dtype: torch.dtype) -> float:
    """A constant rounded to `dtype`, as JAX rounds a weakly typed constant
    to the type of the tensor it meets (torch keeps it in float32)."""
    return float(torch.tensor(c, dtype=dtype))


ACT = {
    "relu": torch.relu,
    "sigmoid": sigmoid,
    "tanh": torch.tanh,
    "identity": lambda x: x,
    None: lambda x: x,
}


# ---------------------------------------------------------------------------
# batch norm 2d
# ---------------------------------------------------------------------------


def init_batchnorm(c: int) -> Tuple[Params, Params]:
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def batchnorm_apply(params: Params, state: Params, x: torch.Tensor, train: bool = False,
                    momentum: float = 0.1, eps: float = 1e-5) -> Tuple[torch.Tensor, Params]:
    """x [B, C, T, F] normalized per channel. Returns (out, state).

    Eval: the running statistics normalize, the state is returned as it is.
    Train: the batch's mean and biased variance over (B, T, F) normalize;
    the new state (a new dict, the input left as it was) moves the running
    statistics by `momentum` towards the batch's mean and unbiased
    variance, outside autograd."""
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        with torch.no_grad():
            new_state = {
                "mean": (1 - momentum) * state["mean"] + momentum * mean,
                "var": (1 - momentum) * state["var"] + momentum * (var * n / max(n - 1, 1)),
            }
        inv = torch.rsqrt(var + eps)
    else:
        mean, new_state = state["mean"], state
        var = state["var"] + _rounded(eps, state["var"].dtype)
        # in float32, rounded once: torch's own bfloat16 rsqrt rounds twice
        # on short tensors and moves a quarter of the values by one unit in
        # the last place
        inv = torch.rsqrt(var.float()).to(var.dtype)
    out = (x - mean[None, :, None, None]) * inv[None, :, None, None]
    out = out * params["scale"][None, :, None, None] + params["bias"][None, :, None, None]
    return out, new_state


# ---------------------------------------------------------------------------
# causal Conv2d block: conv -> [pointwise] -> [bn] -> [act]
# ---------------------------------------------------------------------------


def _conv_groups(in_ch: int, out_ch: int, kernel: Tuple[int, int], separable: bool) -> int:
    """The reference Conv2dNormAct group rule: separable means groups =
    gcd(in, out) on the main conv; a kernel-1 conv keeps its groups (a
    grouped 1x1), only its extra pointwise conv is left out (`has_pw`)."""
    return math.gcd(in_ch, out_ch) if separable else 1


def init_conv2d_norm_act(
    gen: torch.Generator,
    in_ch: int,
    out_ch: int,
    kernel: Tuple[int, int],
    fstride: int = 1,
    dilation: int = 1,
    fpad: bool = True,
    bias: bool = True,
    separable: bool = False,
    norm: bool = True,
    act: Optional[str] = "relu",
    groups: Optional[int] = None,
    lookahead: int = 0,
    fupsample: int = 1,
    force_pw: bool = False,
) -> Tuple[Params, Params, Dict]:
    """Returns (params, state, static_config), the config equal to the JAX
    package's for the same arguments. `groups`, `lookahead`, `fupsample` and
    `force_pw` are DeepFilterNet1's convkxf variants: an explicit group count
    (default: the gcd rule), a time pad of (kT-1-lookahead, lookahead), a
    nearest-neighbour frequency repeat before the conv, and the pointwise
    conv kept for a grouped 1x1."""
    kernel = tuple(kernel)
    if groups is None:
        groups = _conv_groups(in_ch, out_ch, kernel, separable)
    has_pw = separable and groups > 1 and (max(kernel) > 1 or force_pw)
    fan_in = (in_ch // groups) * kernel[0] * kernel[1]
    params: Params = {
        "w": _kaiming_uniform(gen, (out_ch, in_ch // groups, kernel[0], kernel[1]), fan_in)
    }
    if bias:
        params["b"] = _uniform(gen, (out_ch,), 1.0 / math.sqrt(fan_in))
    if has_pw:
        params["pw"] = _kaiming_uniform(gen, (out_ch, out_ch, 1, 1), out_ch)
    state: Params = {}
    if norm:
        params["bn"], state["bn"] = init_batchnorm(out_ch)
    cfg = dict(
        kernel=kernel,
        fstride=fstride,
        dilation=dilation,
        fpad=(kernel[1] // 2 + dilation - 1) if fpad else 0,
        groups=groups,
        act=act,
        norm=norm,
        transposed=False,
        lookahead=lookahead,
        fupsample=fupsample,
    )
    return params, state, cfg


def _conv2d_raw(x, w, groups, fstride, dilation, fpad):
    return F.conv2d(x, w, stride=(1, fstride), padding=(0, fpad),
                    dilation=(1, dilation), groups=groups)


def _finish_seq(params, state, cfg, out, train=False):
    """Bias, pointwise conv, batchnorm and activation on [B, O, T, F'].
    Returns (out, state with the batchnorm's new state)."""
    if "b" in params:
        out = out + params["b"][None, :, None, None]
    if "pw" in params:
        out = F.conv2d(out, params["pw"])
    if cfg["norm"]:
        out, bn = batchnorm_apply(params["bn"], state["bn"], out, train)
        state = dict(state, bn=bn) if train else state
    return ACT[cfg["act"]](out), state


def _finish(params, state, cfg, out):
    return _finish_seq(params, state, cfg, out)[0][:, :, 0, :]


def _fupsample(cfg, x):
    """The nearest-neighbour frequency repeat of an upsampling conv."""
    f = cfg.get("fupsample", 1)
    return torch.repeat_interleave(x, f, dim=-1) if f > 1 else x


def conv2d_norm_act_apply(params: Params, state: Params, cfg: Dict, x: torch.Tensor,
                          train: bool = False) -> Tuple[torch.Tensor, Params]:
    """Whole sequence: x [B, C, T, F] -> ([B, O, T', F'], state), causal in
    time but for `lookahead` frames (time pad (kT-1-la, la)); the state is
    new only in training (`batchnorm_apply`)."""
    kt, la = cfg["kernel"][0], cfg.get("lookahead", 0)
    x = F.pad(x, (0, 0, max(kt - 1 - la, 0), la))
    out = _conv2d_raw(_fupsample(cfg, x), params["w"], cfg["groups"], cfg["fstride"],
                      cfg["dilation"], cfg["fpad"])
    return _finish_seq(params, state, cfg, out, train)


def conv2d_norm_act_step(params: Params, state: Params, cfg: Dict,
                         x_win: torch.Tensor) -> torch.Tensor:
    """One frame. x_win: [B, C, kT, F] (time window ending at the current
    frame) -> [B, O, F']; an upsampling conv repeats the window's bins."""
    out = _conv2d_raw(_fupsample(cfg, x_win), params["w"], cfg["groups"], cfg["fstride"],
                      cfg["dilation"], cfg["fpad"])
    return _finish(params, state, cfg, out)


# ---------------------------------------------------------------------------
# causal ConvTranspose2d block: frequency upsampling decoder convs
# ---------------------------------------------------------------------------


def init_conv_transpose2d_norm_act(
    gen: torch.Generator,
    in_ch: int,
    out_ch: int,
    kernel: Tuple[int, int],
    fstride: int = 1,
    dilation: int = 1,
    fpad: bool = True,
    bias: bool = True,
    separable: bool = False,
    norm: bool = True,
    act: Optional[str] = "relu",
) -> Tuple[Params, Params, Dict]:
    kernel = tuple(kernel)
    groups = math.gcd(in_ch, out_ch) if separable else 1
    has_pw = separable and groups > 1
    fan_in = (out_ch // groups) * kernel[0] * kernel[1]
    params: Params = {
        "w": _kaiming_uniform(gen, (in_ch, out_ch // groups, kernel[0], kernel[1]), fan_in)
    }
    if bias:
        params["b"] = _uniform(gen, (out_ch,), 1.0 / math.sqrt(fan_in))
    if has_pw:
        params["pw"] = _kaiming_uniform(gen, (out_ch, out_ch, 1, 1), out_ch)
    state: Params = {}
    if norm:
        params["bn"], state["bn"] = init_batchnorm(out_ch)
    cfg = dict(
        kernel=kernel,
        fstride=fstride,
        dilation=dilation,
        fpad=(kernel[1] // 2) if fpad else 0,
        groups=groups,
        act=act,
        norm=norm,
        transposed=True,
    )
    return params, state, cfg


def _conv_transpose2d_raw(x, w, groups, fstride, kernel, fpad, dilation):
    """torch ConvTranspose2d with padding=(kT-1, fpad + dilation - 1),
    output_padding=(0, fpad), stride=(1, fstride), written out as a
    convolution of the frequency-dilated input with the flipped,
    channel-transposed kernel (the JAX package's form). The time axis needs
    no padding here: the caller's input already holds the kT-1 past frames
    (a streaming window, or the causal pad of the sequence form)."""
    kt, kf = kernel
    p_f = fpad + dilation - 1
    pad_l = dilation * (kf - 1) - p_f
    pad_r = dilation * (kf - 1) - p_f + fpad
    b, c, t, f = x.shape
    if fstride > 1:
        xd = x.new_zeros((b, c, t, (f - 1) * fstride + 1))
        xd[..., ::fstride] = x
        x = xd
    # negative padding crops, as lax.conv_general_dilated does
    x = F.pad(x, (pad_l, pad_r))
    ig = c // groups
    og = w.shape[1]
    w_r = torch.flip(w, dims=(2, 3)).reshape(groups, ig, og, kt, kf)
    w_r = w_r.transpose(1, 2).reshape(groups * og, ig, kt, kf)
    return F.conv2d(x, w_r, dilation=(1, dilation), groups=groups)


def conv_transpose2d_norm_act_apply(params: Params, state: Params, cfg: Dict,
                                    x: torch.Tensor, train: bool = False
                                    ) -> Tuple[torch.Tensor, Params]:
    """Whole sequence, causal in time: x [B, C, T, F] -> ([B, O, T,
    F*fstride], state), the state new only in training."""
    x = F.pad(x, (0, 0, cfg["kernel"][0] - 1, 0))
    out = _conv_transpose2d_raw(x, params["w"], cfg["groups"], cfg["fstride"],
                                cfg["kernel"], cfg["fpad"], cfg["dilation"])
    return _finish_seq(params, state, cfg, out, train)


def conv_transpose2d_norm_act_step(params: Params, state: Params, cfg: Dict,
                                   x_win: torch.Tensor) -> torch.Tensor:
    """One frame. x_win: [B, C, kT, F] -> [B, O, F*fstride]."""
    out = _conv_transpose2d_raw(x_win, params["w"], cfg["groups"], cfg["fstride"],
                                cfg["kernel"], cfg["fpad"], cfg["dilation"])
    return _finish(params, state, cfg, out)


# ---------------------------------------------------------------------------
# linear / grouped linear
# ---------------------------------------------------------------------------


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int, bias: bool = True) -> Params:
    p = {"w": _kaiming_uniform(gen, (out_dim, in_dim), in_dim)}
    if bias:
        p["b"] = _uniform(gen, (out_dim,), 1.0 / math.sqrt(in_dim))
    return p


def linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    out = x @ params["w"].T
    if "b" in params:
        out = out + params["b"]
    return out


def init_grouped_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                        groups: int = 1) -> Params:
    """Weight [G, I/G, H/G]."""
    if in_dim % groups or out_dim % groups:
        raise ValueError("grouped linear widths must divide by the group count")
    ws = in_dim // groups
    return {"w": _kaiming_uniform(gen, (groups, ws, out_dim // groups), ws)}


def grouped_linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [..., I] -> [..., H]."""
    g, ws, hs = params["w"].shape
    xg = x.reshape(x.shape[:-1] + (g, ws))
    out = torch.einsum("...gi,gih->...gh", xg, params["w"])
    return out.reshape(x.shape[:-1] + (g * hs,))


# ---------------------------------------------------------------------------
# GRU (torch gate conventions)
# ---------------------------------------------------------------------------


def init_gru(gen: torch.Generator, input_size: int, hidden_size: int,
             num_layers: int = 1) -> Params:
    bound = 1.0 / math.sqrt(hidden_size)
    layers = []
    for li in range(num_layers):
        isz = input_size if li == 0 else hidden_size
        layers.append({
            "w_ih": _uniform(gen, (3 * hidden_size, isz), bound),
            "w_hh": _uniform(gen, (3 * hidden_size, hidden_size), bound),
            "b_ih": _uniform(gen, (3 * hidden_size,), bound),
            "b_hh": _uniform(gen, (3 * hidden_size,), bound),
        })
    return {"layers": layers}


def _gru_cell(h, x, lp):
    gi = x @ lp["w_ih"].T + lp["b_ih"]
    gh = h @ lp["w_hh"].T + lp["b_hh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = sigmoid(i_r + h_r)
    z = sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_apply(params: Params, x: torch.Tensor, h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole sequence. x: [B, T, I]; h0: [L, B, H] (default zeros). Returns
    (out [B, T, H], hN [L, B, H]).

    The stack is one `aten.gru` call (cuDNN on the card, ATen on the CPU):
    the same gate form as `_gru_cell`, with b_hn inside r * (W_hn h + b_hn).
    It runs in training mode when autograd needs its backward (cuDNN has
    none for an inference-mode call).
    """
    layers = params["layers"]
    hidden = layers[0]["w_hh"].shape[1]
    if h0 is None:
        h0 = x.new_zeros((len(layers), x.shape[0], hidden))
    weights = [lp[k] for lp in layers for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    weights_grad = torch.is_grad_enabled() and any(w.requires_grad for w in weights)
    train = weights_grad or (torch.is_grad_enabled() and (x.requires_grad or h0.requires_grad))
    if x.is_cuda and torch._use_cudnn_rnn_flatten_weight():
        flatten = _cudnn_gru_leaves if weights_grad else _cudnn_gru_weights
        weights = flatten(weights, len(layers), hidden)
    out, h_n = torch.ops.aten.gru.input(x, h0.contiguous(), weights, True, len(layers),
                                        0.0, train, False, True)
    return out, h_n


def _cudnn_flatten(weights, n_layers: int, hidden: int):
    """Point each tensor into one new buffer in cuDNN's layout, values kept."""
    from torch.backends.cudnn import rnn as cudnn_rnn

    with torch.no_grad():
        torch._cudnn_rnn_flatten_weight(
            weights, 4, weights[0].shape[1], cudnn_rnn.get_cudnn_mode("GRU"),
            hidden, 0, n_layers, True, False)


# cuDNN's one-buffer copy of a GRU stack's weights, found again by the stack's
# first weight tensor while it lives
_CUDNN_GRU = WeakIdKeyDictionary()


def _cudnn_gru_weights(weights, n_layers: int, hidden: int):
    """A copy of the stack's weights as views into one buffer in cuDNN's
    layout, made once per weight set (checked by identity and version; a
    bfloat16 runtime's cast parameters are a set of their own). With
    separate tensors cuDNN copies them into such a buffer at every call, and
    warns each time. Inference only: autograd does not reach the copy."""
    stamp = tuple((id(w), w._version) for w in weights)
    hit = _CUDNN_GRU.get(weights[0])
    if hit is None or hit[0] != stamp:
        flat = [w.detach().clone() for w in weights]
        _cudnn_flatten(flat, n_layers, hidden)
        hit = (stamp, flat)
        _CUDNN_GRU[weights[0]] = hit
    return hit[1]


# the stacks whose own weight tensors were moved into one buffer, by the
# stack's first tensor, with the identities of all of them
_CUDNN_GRU_LEAVES = WeakIdKeyDictionary()


def _cudnn_gru_leaves(weights, n_layers: int, hidden: int):
    """The stack's own weight tensors, moved once into one buffer in cuDNN's
    layout (what `nn.GRU.flatten_parameters` does), so that autograd reaches
    them and cuDNN copies nothing per call; updating them in place (an
    optimizer step) keeps them there."""
    stamp = tuple(id(w) for w in weights)
    if _CUDNN_GRU_LEAVES.get(weights[0]) != stamp:
        _cudnn_flatten(weights, n_layers, hidden)
        _CUDNN_GRU_LEAVES[weights[0]] = stamp
    return weights


def gru_step(params: Params, h: torch.Tensor, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame. x: [B, I]; h: [L, B, H]. Returns (h' [L, B, H], out [B, H])."""
    out = x
    new_h = []
    for li, lp in enumerate(params["layers"]):
        out = _gru_cell(h[li], out, lp)
        new_h.append(out)
    return torch.stack(new_h, dim=0), out


# ---------------------------------------------------------------------------
# SqueezedGRU_S: grouped linear in -> GRU -> grouped linear out; the skip is
# added after linear_out and fed by the raw input
# ---------------------------------------------------------------------------


def init_squeezed_gru_s(
    gen: torch.Generator,
    input_size: int,
    hidden_size: int,
    output_size: Optional[int] = None,
    num_layers: int = 1,
    linear_groups: int = 8,
    skip: Optional[str] = None,  # None | "identity" | "groupedlinear"
    linear_act: Optional[str] = "relu",
) -> Tuple[Params, Dict]:
    params: Params = {
        "linear_in": init_grouped_linear(gen, input_size, hidden_size, linear_groups),
        "gru": init_gru(gen, hidden_size, hidden_size, num_layers),
    }
    if output_size is not None:
        params["linear_out"] = init_grouped_linear(gen, hidden_size, output_size, linear_groups)
    if skip == "groupedlinear":
        out_sz = output_size if output_size is not None else hidden_size
        params["skip"] = init_grouped_linear(gen, input_size, out_sz, linear_groups)
    cfg = dict(skip=skip, linear_act=linear_act, num_layers=num_layers,
               hidden_size=hidden_size)
    return params, cfg


def squeezed_gru_s_apply(params: Params, cfg: Dict, x: torch.Tensor,
                         h0: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole sequence. x: [B, T, I]; h0: [L, B, H]. Returns (out, hN)."""
    act = ACT[cfg["linear_act"]]
    xin = act(grouped_linear_apply(params["linear_in"], x))
    out, h = gru_apply(params["gru"], xin, h0)
    return _squeezed_out(params, cfg, act, x, out), h


def squeezed_gru_s_step(params: Params, cfg: Dict, h: torch.Tensor, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame. x: [B, I]; h: [L, B, H]. Returns (h', out)."""
    act = ACT[cfg["linear_act"]]
    xin = act(grouped_linear_apply(params["linear_in"], x))
    h_new, out = gru_step(params["gru"], h, xin)
    return h_new, _squeezed_out(params, cfg, act, x, out)


def _squeezed_out(params, cfg, act, x, out):
    """linear_out and the skip from the raw input x."""
    if "linear_out" in params:
        out = act(grouped_linear_apply(params["linear_out"], out))
    if cfg["skip"] == "identity":
        out = out + x
    elif cfg["skip"] == "groupedlinear":
        out = out + grouped_linear_apply(params["skip"], x)
    return out


# ---------------------------------------------------------------------------
# GroupedLinear: a linear layer (with bias) a group, then an optional channel
# shuffle of the output
# ---------------------------------------------------------------------------


def init_grouped_linear_shuffle(gen: torch.Generator, in_dim: int, out_dim: int,
                                groups: int = 1, shuffle: bool = True
                                ) -> Tuple[Params, Dict]:
    """Params {"layers": [linear a group]}, cfg {groups, shuffle}; a single
    group never shuffles."""
    if in_dim % groups or out_dim % groups:
        raise ValueError("grouped linear widths must divide by the group count")
    layers = [init_linear(gen, in_dim // groups, out_dim // groups) for _ in range(groups)]
    return {"layers": layers}, dict(groups=groups, shuffle=shuffle and groups > 1)


def _shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The channel shuffle of the last axis, as the reference's: viewed as
    [..., H/G, G] and transposed to [..., G, H/G]."""
    return x.reshape(x.shape[:-1] + (-1, groups)).transpose(-1, -2).reshape(x.shape)


def grouped_linear_shuffle_apply(params: Params, cfg: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: [..., I] -> [..., H]."""
    g = cfg["groups"]
    isz = x.shape[-1] // g
    out = torch.cat([linear_apply(lp, x[..., i * isz:(i + 1) * isz])
                     for i, lp in enumerate(params["layers"])], dim=-1)
    return _shuffle(out, g) if cfg["shuffle"] else out


# ---------------------------------------------------------------------------
# GroupedGRU: a GRU a group and layer, the channel shuffle between layers,
# optionally the layers' outputs summed
# ---------------------------------------------------------------------------


def init_grouped_gru(gen: torch.Generator, input_size: int, hidden_size: int,
                     num_layers: int = 1, groups: int = 4, shuffle: bool = True,
                     add_outputs: bool = False) -> Tuple[Params, Dict]:
    """Params {"layers": [[one-layer GRU a group] a layer]}; the carry is
    [L*G, B, H/G], layer-major."""
    if input_size % groups or hidden_size % groups:
        raise ValueError("grouped GRU widths must divide by the group count")
    layers = []
    for li in range(num_layers):
        isz = (input_size if li == 0 else hidden_size) // groups
        layers.append([init_gru(gen, isz, hidden_size // groups, 1) for _ in range(groups)])
    cfg = dict(groups=groups, shuffle=shuffle and groups > 1, add_outputs=add_outputs,
               num_layers=num_layers, hidden_size=hidden_size // groups)
    return {"layers": layers}, cfg


def _grouped_layers(params: Params, cfg: Dict, x: torch.Tensor, run):
    """The grouped stack over `x` [..., I]: run(li, gi, group params, group
    input) -> (output, new hidden); returns (summed or last output, hiddens
    in carry order)."""
    g, n_layers = cfg["groups"], cfg["num_layers"]
    cur, acc, hs = x, None, []
    for li, layer in enumerate(params["layers"]):
        isz = cur.shape[-1] // g
        outs = []
        for gi, gp in enumerate(layer):
            o, h = run(li * g + gi, gp, cur[..., gi * isz:(gi + 1) * isz])
            outs.append(o)
            hs.append(h)
        cur = torch.cat(outs, dim=-1)
        if cfg["shuffle"] and li < n_layers - 1:
            cur = _shuffle(cur, g)
        acc = cur if acc is None or not cfg["add_outputs"] else acc + cur
    return acc, hs


def grouped_gru_apply(params: Params, cfg: Dict, x: torch.Tensor,
                      h0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole sequence. x: [B, T, I]; h0: [L*G, B, H/G] (default zeros).
    Returns (out [B, T, H], hN [L*G, B, H/G]); each group's GRU is one
    `aten.gru` call."""
    def run(k, gp, xg):
        out, h = gru_apply(gp, xg, None if h0 is None else h0[k:k + 1])
        return out, h[0]

    out, hs = _grouped_layers(params, cfg, x, run)
    return out, torch.stack(hs, dim=0)


def grouped_gru_step(params: Params, cfg: Dict, h: torch.Tensor, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame. x: [B, I]; h: [L*G, B, H/G]. Returns (h', out [B, H])."""
    def run(k, gp, xg):
        h_new, out = gru_step(gp, h[k:k + 1], xg)
        return out, h_new[0]

    out, hs = _grouped_layers(params, cfg, x, run)
    return torch.stack(hs, dim=0), out


# ---------------------------------------------------------------------------
# SqueezedGRU (DFN2): grouped linear in -> GRU -> grouped linear out; the
# skip is added to the GRU's output from its input (after linear_in), before
# linear_out
# ---------------------------------------------------------------------------


def init_squeezed_gru(
    gen: torch.Generator,
    input_size: int,
    hidden_size: int,
    output_size: Optional[int] = None,
    num_layers: int = 1,
    linear_groups: int = 8,
    skip: Optional[str] = None,  # None | "identity"
    linear_act: Optional[str] = "identity",
) -> Tuple[Params, Dict]:
    params: Params = {
        "linear_in": init_grouped_linear(gen, input_size, hidden_size, linear_groups),
        "gru": init_gru(gen, hidden_size, hidden_size, num_layers),
    }
    if output_size is not None:
        params["linear_out"] = init_grouped_linear(gen, hidden_size, output_size, linear_groups)
    cfg = dict(skip=skip, linear_act=linear_act, num_layers=num_layers,
               hidden_size=hidden_size)
    return params, cfg


def _squeezed_skip_out(params, cfg, act, xin, out):
    if cfg["skip"] == "identity":
        out = out + xin
    if "linear_out" in params:
        out = act(grouped_linear_apply(params["linear_out"], out))
    return out


def squeezed_gru_apply(params: Params, cfg: Dict, x: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole sequence. x: [B, T, I]; h0: [L, B, H]. Returns (out, hN)."""
    act = ACT[cfg["linear_act"]]
    xin = act(grouped_linear_apply(params["linear_in"], x))
    out, h = gru_apply(params["gru"], xin, h0)
    return _squeezed_skip_out(params, cfg, act, xin, out), h


def squeezed_gru_step(params: Params, cfg: Dict, h: torch.Tensor, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame. x: [B, I]; h: [L, B, H]. Returns (h', out)."""
    act = ACT[cfg["linear_act"]]
    xin = act(grouped_linear_apply(params["linear_in"], x))
    h_new, out = gru_step(params["gru"], h, xin)
    return h_new, _squeezed_skip_out(params, cfg, act, xin, out)
