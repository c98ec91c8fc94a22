"""The train step (the reference's df/train.py:47-457), after
`deepfilternet_tpu.train.trainer`.

    opt = make_optimizer()                       # [optim] section
    ts = init_train_state(params, state, opt)    # leaves that require grad
    step = make_train_step(module, cfg, Loss(...), trainable=None)
    ts, metrics = step(ts, batch, lr, wd)

A step runs the family's `forward(train=True)` and the configured losses,
takes every parameter's gradient with autograd, clips their global norm at
1.0 and steps a `torch.optim` optimizer (`TrainState.opt_state`), which
updates `ts.params` in place; the new batch-norm running statistics come
back from the forward. The NaN guard (train.py:381-419): after a non-finite
loss or gradient the parameters, the batch-norm state and the optimizer
stay exactly as they were (`step()` is not called, so no per-parameter step
count advances) and `nan_count` rises by one, which the host checks against
MAX_NANS. Unlike JAX's `make_train_step`, the port's takes no optimizer:
the state holds it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from deepfilternet_torch.config import Csv, config
from deepfilternet_torch.train.loss import Loss

MAX_NANS = 50
CLIP_NORM = 1.0


class TrainState(NamedTuple):
    params: Any  # tree of leaf tensors that require grad, updated in place
    model_state: Any  # batch-norm running statistics
    opt_state: torch.optim.Optimizer
    step: int
    nan_count: int


def load_opt_config() -> Dict[str, Any]:
    """[optim] section defaults (df/train.py:474-512)."""
    betas = tuple(float(b) for b in config("OPT_BETAS", (0.9, 0.999), Csv(float),
                                           section="optim"))
    return dict(
        lr=config("LR", 5e-4, float, section="optim"),
        weight_decay=config("WEIGHT_DECAY", 0.05, float, section="optim"),
        optimizer=config("OPTIMIZER", "adamw", str, section="optim"),
        betas=betas,
        # the reference builds Adam/AdamW with amsgrad=True (df/train.py:494-496)
        amsgrad=config("AMSGRAD", True, bool, section="optim"),
        lr_min=config("LR_MIN", 1e-6, float, section="optim"),
        lr_warmup=config("LR_WARMUP", 1e-4, float, section="optim"),
        warmup_epochs=config("WARMUP_EPOCHS", 3, int, section="optim"),
        lr_cycle_mul=config("LR_CYCLE_MUL", 1.0, float, section="optim"),
        lr_cycle_decay=config("LR_CYCLE_DECAY", 0.5, float, section="optim"),
        lr_cycle_epochs=config("LR_CYCLE_EPOCHS", -1, int, section="optim"),
        weight_decay_end=config("WEIGHT_DECAY_END", -1, float, section="optim"),
    )


class RMSpropOptax(torch.optim.Optimizer):
    """RMSprop as optax.rmsprop computes it (decay 0.9, eps 1e-8 inside the
    square root, a zero initial scale, the lr applied before the momentum
    trace). torch.optim.RMSprop adds eps outside the square root and applies
    the lr after the trace, which differs once the lr changes between steps."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    st["trace"] = torch.zeros_like(p)
                st["nu"].mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1 - group["decay"])
                update = p.grad * torch.rsqrt(st["nu"] + group["eps"])
                st["trace"].mul_(group["momentum"]).add_(update, alpha=-group["lr"])
                p.add_(st["trace"])


def make_optimizer(opt_cfg: Optional[Dict] = None
                   ) -> Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]:
    """A function of the parameter tensors that builds the `torch.optim`
    optimizer equal, step for step, to JAX's optax chain after its clip:

      * "adamw": AdamW, decoupled weight decay (amsgrad by default: torch's
        own AMSGrad is what JAX's `scale_by_amsgrad_torch` reproduces);
      * "adam": with amsgrad, Adam with coupled L2 (the decay added to the
        gradient); without, Adam with no decay (optax.adam);
      * "sgd": Nesterov momentum 0.9, the decay added to the gradient;
      * "rmsprop": `RMSpropOptax`, optax.rmsprop(lr, momentum=0.9).

    The lr and, where JAX injects it (adamw; adam with amsgrad), the weight
    decay are set per step by `_set_lr`.
    """
    opt_cfg = opt_cfg or load_opt_config()
    name = opt_cfg.get("optimizer", "adamw")
    betas = tuple(opt_cfg.get("betas", (0.9, 0.999)))
    amsgrad = opt_cfg.get("amsgrad", True)
    wd = opt_cfg["weight_decay"]
    if name == "adamw":
        cls, kw, inject = torch.optim.AdamW, dict(betas=betas, eps=1e-8, weight_decay=wd,
                                                  amsgrad=amsgrad), True
    elif name == "adam":
        cls, kw, inject = torch.optim.Adam, dict(betas=betas, eps=1e-8,
                                                 weight_decay=wd if amsgrad else 0.0,
                                                 amsgrad=amsgrad), amsgrad
    elif name == "sgd":
        cls, kw, inject = torch.optim.SGD, dict(momentum=0.9, nesterov=True,
                                                weight_decay=wd), False
    elif name == "rmsprop":
        cls, kw, inject = RMSpropOptax, dict(momentum=0.9), False
    else:
        raise ValueError(f"Unknown optimizer {name}")

    def build(params: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
        return cls([{"params": list(params), "inject_weight_decay": inject}],
                   lr=opt_cfg["lr"], **kw)

    return build


def _set_lr(optimizer: torch.optim.Optimizer, lr, wd=None):
    """This step's lr, and weight decay where the optimizer takes it."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
        if wd is not None and group["inject_weight_decay"]:
            group["weight_decay"] = float(wd)


# DF-decoder top-level param keys across the families, frozen under
# MASK_ONLY as the reference's optimizer filter does (df/train.py:490-494);
# the encoder-side df_conv0/1 and df_fc_emb stay trainable
DF_DECODER_KEYS = ("df_gru", "df_skip", "df_convp", "df_out", "df_fc_a")


def trainable_filter(mask_only: bool = False, df_only: bool = False):
    """Top-level param-key predicate (df/train.py:486-494), or None."""
    if mask_only:
        return lambda k: k not in DF_DECODER_KEYS
    if df_only:
        return lambda k: "df" in k.lower()
    return None


def _leaves(tree, key=None) -> List[Tuple[str, torch.Tensor]]:
    """(top-level key, tensor) of every leaf, keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], k if key is None else key)]
    if isinstance(tree, (list, tuple)):
        return [kv for v in tree for kv in _leaves(v, key)]
    return [(key, tree)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: above `max_norm`, every gradient
    is divided by the global norm and times max_norm. Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_div_(grads, torch.where(norm < max_norm, 1.0, norm / max_norm))
    return norm


def make_train_step(module, cfg: Dict, loss_obj: Loss,
                    trainable: Optional[Callable[[str], bool]] = None) -> Callable:
    """The train step of an offline-forward model module:
    step(ts, batch, lr, wd) -> (ts', metrics).

    `batch` holds "noisy" and "clean" [B, T, F, 2], "feat_erb" [B, T, E] and
    "feat_spec" [B, T, F', 2] on the parameters' device; `metrics` "loss",
    "finite" and each loss part. `trainable`: an optional predicate over
    top-level param keys; the keys it refuses get no update and no weight
    decay, but their gradients count in the clip norm, as in JAX."""
    # DFN1/DFN2 forwards give the DF alpha as the 4th output (DfAlphaLoss);
    # DFN3's 4th output is its coefficients
    returns_alpha = cfg.get("generation", 3) in (1, 2)

    def train_step(ts: TrainState, batch: Dict, lr, wd):
        _set_lr(ts.opt_state, lr, wd)
        leaves = _leaves(ts.params)
        tensors = [t for _, t in leaves]
        (spec_e, m, lsnr, aux), new_model_state = module.forward(
            ts.params, ts.model_state, cfg, batch["noisy"], batch["feat_erb"],
            batch["feat_spec"], train=True)

        def cplx(ri):
            return torch.complex(ri[..., 0], ri[..., 1])

        loss, parts = loss_obj(cplx(batch["clean"]), cplx(batch["noisy"]), cplx(spec_e), m, lsnr,
                               df_alpha=aux if returns_alpha else None)
        # a parameter the loss does not reach has a zero gradient, as in JAX
        # (its weight decay and moments still move)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(tensors, torch.autograd.grad(loss, tensors, allow_unused=True))]
        finite = torch.isfinite(loss) & torch.isfinite(
            torch.stack(torch._foreach_norm(grads, float("inf")))).all()
        if bool(finite):  # the step's one wait for the device
            clip_by_global_norm_(grads, CLIP_NORM)
            for (k, t), g in zip(leaves, grads):
                t.grad = g if trainable is None or trainable(k) else None
            ts.opt_state.step()
            for t in tensors:
                t.grad = None
            model_state, nan_count = new_model_state, ts.nan_count
        else:
            model_state, nan_count = ts.model_state, ts.nan_count + 1
        metrics = {"loss": loss.detach(), "finite": finite,
                   **{k: v.detach() for k, v in parts.items()}}
        return ts._replace(model_state=model_state, step=ts.step + 1,
                           nan_count=nan_count), metrics

    return train_step


def init_train_state(params, model_state, optimizer) -> TrainState:
    """Copies of `params` as leaf tensors that require grad (the caller's
    tree is left as it is), the optimizer over all of them."""
    params = _map(lambda t: t.detach().clone().requires_grad_(True), params)
    return TrainState(params=params, model_state=model_state,
                      opt_state=optimizer([t for _, t in _leaves(params)]), step=0, nan_count=0)
