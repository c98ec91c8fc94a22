"""Train a bundled fixture-demo model (any generation) on a small corpus.

The repo ships small fixture-trained demo checkpoints, one per generation,
under `pretrained/<name>_fixture_demo`. This driver (re)trains one of them
with the port's training stack, on the device:

    python -m deepfilternet_torch.scripts.train_demo MODEL_DIR [seconds] [lr] [--device cpu]

MODEL_DIR holds a `config.ini` selecting the model and its losses; the best
checkpoint goes to MODEL_DIR/checkpoints (resumed from there when it is
compatible). The corpus is `clean.hdf5` and `noise_flac.hdf5` in
`$DEMO_ASSETS` (default `assets`, relative to the working directory), as
`scripts/prepare_data.py` writes them; a fixed pool of batches from
`$DEMO_POOLS` distinct epoch seeds is trained over again and again until the
time budget is spent: a check of the whole train -> inference stack, not a
real corpus.

Knobs (environment): DEMO_MAX_LEN_S (crop, s), DEMO_SNRS, DEMO_BATCH,
DEMO_EXTRA_CLEAN ("file:factor", another speech pool), DEMO_ASSETS,
DEMO_POOLS, DEMO_POOL_OFFSET (first epoch seed), DEMO_PAD_FRAMES (padded
STFT frame count; a value above 10x the longest batch is refused unless
DEMO_PAD_FRAMES_FORCE is set), DEMO_P_REVERB, DEMO_P_INTERFER.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from deepfilternet_torch.checkpoint import (
    optimizer_state_from_numpy,
    params_from_numpy,
    read_cp,
    write_cp,
)
from deepfilternet_torch.config import config

# the fixture-demo loss stack (the reference's training defaults), set
# where config.ini leaves them out
LOSS_DEFAULTS = (
    ("SpectralLoss", "factor_magnitude", "100"),
    ("SpectralLoss", "factor_complex", "100"),
    ("SpectralLoss", "gamma", "0.6"),
    ("MaskLoss", "factor", "1"),
    ("LocalSnrLoss", "factor", "0.0005"),
)


def load_demo_config(model_dir: str):
    """The config of MODEL_DIR with the demo's loss defaults."""
    config.reset()
    ini = os.path.join(model_dir, "config.ini")
    if os.path.isfile(ini):
        config.load(ini)
    for sec, k, v in LOSS_DEFAULTS:
        if not config.obj.parser.has_option(sec, k):
            config.set(k, v, section=sec)


def demo_loader():
    """The demo corpus's DataLoader, from the DEMO_* knobs."""
    from deepfilternet_torch.data.dataloader import DataLoader
    from deepfilternet_torch.data.dataset import FdDataset, Hdf5Cfg, TdDataset

    env = os.environ.get
    snrs = tuple(int(s) for s in env("DEMO_SNRS", "-5,0,5,10,20,40").split(","))
    cfgs = [Hdf5Cfg("clean.hdf5", 16), Hdf5Cfg("noise_flac.hdf5", 1)]
    extra_clean = env("DEMO_EXTRA_CLEAN")
    if extra_clean:
        fn, fac = extra_clean.rsplit(":", 1)
        cfgs.insert(1, Hdf5Cfg(fn, float(fac)))
    td = TdDataset(env("DEMO_ASSETS", "assets"), cfgs, "train",
                   max_len_s=float(env("DEMO_MAX_LEN_S", "3.0")), snrs=snrs, seed=1,
                   p_reverb=float(env("DEMO_P_REVERB", "0")),
                   p_interfer_sp=float(env("DEMO_P_INTERFER", "0")))
    return DataLoader(FdDataset(td), batch_size=int(env("DEMO_BATCH", "8")),
                      num_workers=6, drop_last=True)


def batch_pool(dl, n_pools: int, offset: int = 0):
    """(the first epoch's batches, every batch of `n_pools` distinct epochs
    from seed `offset` as `batch_to_arrays` gives them)."""
    from deepfilternet_torch.train.run import batch_to_arrays

    first = list(dl.iter_epoch("train", offset))
    raw = []
    for ep in range(offset, offset + n_pools):
        for b in (first if ep == offset else dl.iter_epoch("train", ep)):
            raw.append(batch_to_arrays(b))
    return first, raw


def pad_pool(raw, pad_frames: int = 0, force: bool = False):
    """Every batch zero-padded to one [B, T] frame count: the longest, or
    `pad_frames` (STFT frames, ~100 a second). The padding enters the loss
    means, as in the JAX demo trainer. Returns (T, padded batches)."""
    tmax = max(a["noisy"].shape[1] for a in raw)
    if pad_frames > 10 * tmax and not force:
        # a sample count passed here would pad ~GB per batch
        raise SystemExit(
            f"DEMO_PAD_FRAMES={pad_frames} is frames (got tmax={tmax}); "
            "passing a sample count here pads ~GB per batch "
            "(set DEMO_PAD_FRAMES_FORCE=1 to override)")
    if pad_frames:
        if pad_frames < tmax:
            raise ValueError(f"DEMO_PAD_FRAMES={pad_frames} is below the longest batch ({tmax})")
        tmax = pad_frames
    return tmax, [
        {k: np.pad(v, [(0, 0), (0, tmax - v.shape[1])] + [(0, 0)] * (v.ndim - 2))
         for k, v in a.items()}
        for a in raw
    ]


def _same_shapes(a, b) -> bool:
    """The numpy tree `a` has the layout and leaf shapes of the tensor tree `b`."""
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(
            _same_shapes(a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return isinstance(a, (list, tuple)) and len(a) == len(b) and all(
            _same_shapes(x, y) for x, y in zip(a, b))
    return tuple(np.shape(a)) == tuple(b.shape)


def _resume(ts, payload, device, optimizer):
    """The train state from a checkpoint: (state, first step). An
    incompatible architecture trains from scratch; an optimizer state that
    does not fit restarts the optimizer and keeps the parameters."""
    from deepfilternet_torch.train.trainer import init_train_state

    if not _same_shapes(payload["params"], ts.params):
        print("checkpoint incompatible with current architecture; training from scratch")
        return ts, 0
    params, state = params_from_numpy(payload["params"], payload["state"], device)
    ts = init_train_state(params, state if payload["state"] else ts.model_state, optimizer)
    if "opt_state" in payload:
        try:
            ts.opt_state.load_state_dict(optimizer_state_from_numpy(payload["opt_state"]))
            mismatch = False
        except (ValueError, KeyError):
            mismatch = True
    else:
        # `read_cp` drops an optimizer state that is not a torch optimizer's
        mismatch = bool(payload.get("opt_state_dropped"))
    if mismatch:
        # restoring a state written under another optimizer would fail at
        # the first update
        ts = init_train_state(params, ts.model_state, optimizer)
        print("checkpoint opt_state does not match the current optimizer; "
              "restarting optimizer state (params warm-started)")
    print(f"resumed from step {payload['epoch']}")
    return ts, payload["epoch"]


def _copy(tree):
    """A copy of a tree of dicts, lists and tensors, detached."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _snapshot(ts):
    """(params, batch-norm state, optimizer state dict), copied: the steps
    update the parameters and the optimizer's moments in place."""
    return _copy((ts.params, ts.model_state, ts.opt_state.state_dict()))


def main(model_dir: str, budget_s: float = 600.0, lr: float = 3e-4, device=None) -> None:
    """Train MODEL_DIR's model for `budget_s` seconds of steps at `lr` on
    `device` (default: the CUDA device) and write its best checkpoint."""
    from deepfilternet_torch.enhance import resolve_device
    from deepfilternet_torch.eval.evaluation import si_sdr_np
    from deepfilternet_torch.models import init_model, model_module
    from deepfilternet_torch.ops.erb import erb_widths
    from deepfilternet_torch.ops.stft import Stft, istft
    from deepfilternet_torch.train.loss import Loss
    from deepfilternet_torch.train.run import to_device
    from deepfilternet_torch.train.trainer import (
        init_train_state,
        make_optimizer,
        make_train_step,
        trainable_filter,
    )

    dev = resolve_device(device)
    load_demo_config(model_dir)
    params, state, cfg, module = init_model(device=dev)
    p = model_module()[2]()
    mask_only = config("MASK_ONLY", False, bool, section="train")
    df_only = config("DF_ONLY", False, bool, section="train")
    if mask_only:
        cfg = dict(cfg, run_df=False)

    dl = demo_loader()
    stft_cfg = Stft(p.sr, p.fft_size, p.hop_size)
    loss_obj = Loss(stft_cfg, erb_widths(p.sr, p.fft_size, p.nb_erb, p.min_nb_freqs),
                    p.nb_df, (p.lsnr_min, p.lsnr_max))
    step = make_train_step(module, cfg, loss_obj, trainable=trainable_filter(mask_only, df_only))
    optimizer = make_optimizer()
    ts = init_train_state(params, state, optimizer)

    ckpt_dir = os.path.join(model_dir, "checkpoints")
    step0 = 0
    payload = read_cp(ckpt_dir, "latest")
    if payload is not None:
        ts, step0 = _resume(ts, payload, dev, optimizer)

    # the fixture corpus is tiny: cycle over several distinct epoch pools
    # (fresh SNR, gain, augmentation and noise draws per epoch seed)
    n_pools = int(os.environ.get("DEMO_POOLS", "12"))
    offset = int(os.environ.get("DEMO_POOL_OFFSET", "0"))
    t_pool = time.time()
    first, raw = batch_pool(dl, n_pools, offset)
    print(f"pool: {len(raw)} batches from {n_pools} epochs "
          f"in {time.time() - t_pool:.0f}s", flush=True)
    t_h2d = time.time()
    tmax, padded = pad_pool(raw, int(os.environ.get("DEMO_PAD_FRAMES", "0")),
                            bool(os.environ.get("DEMO_PAD_FRAMES_FORCE")))
    arr_pool = [to_device(a, dev) for a in padded]
    print(f"pad to {tmax} frames + H2D: {time.time() - t_h2d:.0f}s", flush=True)

    lr_t, wd_t = torch.tensor(lr), torch.tensor(0.05)
    t0 = t_rep = time.time()
    losses = []
    n = step0
    window = max(len(arr_pool), 8)
    # (window average, snapshot, step), the starting point until a window
    # of steps has run, as in the JAX demo trainer
    best = (float("inf"), _snapshot(ts), n)
    while time.time() - t0 < budget_s:
        for arrays in arr_pool:
            ts, m = step(ts, arrays, lr_t, wd_t)
            losses.append(float(m["loss"]))
            n += 1
            if n - step0 == 1:
                print(f"step 1: {time.time() - t0:.1f}s", flush=True)
            elif time.time() - t_rep > 60:
                t_rep = time.time()
                print(f"step {n}: loss(avg {min(len(losses), window)}) "
                      f"{np.mean(losses[-window:]):.4f}  "
                      f"{(n - step0) / (t_rep - t0):.1f} steps/s", flush=True)
        if len(losses) >= window:
            avg = float(np.mean(losses[-window:]))
            if avg < best[0]:
                best = (avg, _snapshot(ts), n)
    elapsed = time.time() - t0
    if best[2] != n:
        print(f"final avg loss {np.mean(losses[-window:]):.4f} > best "
              f"{best[0]:.4f} at step {best[2]}; keeping best")
    _, (params_b, state_b, opt_b), n_b = best
    write_cp(ckpt_dir, params_b, state_b, n_b, opt_state=opt_b, keep_n=1, is_best=True)
    print(f"steps {step0}->{n} (kept {n_b}), loss {np.mean(losses[:3]):.4f} "
          f"-> {best[0]:.4f}, {(n - step0) / elapsed:.2f} steps/s")

    with torch.no_grad():
        arrays = arr_pool[0]
        (spec_e, _, _, _), _ = module.forward(params_b, state_b, cfg,
                                              arrays["noisy"], arrays["feat_erb"],
                                              arrays["feat_spec"])
        enh = istft(torch.complex(spec_e[..., 0], spec_e[..., 1]), stft_cfg).cpu().numpy()
    batch = first[0]
    d = p.fft_size - p.hop_size
    se, sn = [], []
    for i in range(enh.shape[0]):
        t = min(enh.shape[-1], batch.speech.shape[-1])
        se.append(si_sdr_np(enh[i, d:t], batch.speech[i, 0, : t - d]))
        sn.append(si_sdr_np(batch.noisy[i, 0, :t], batch.speech[i, 0, :t]))
    print(f"train-set si_sdr noisy={np.mean(sn):.2f} dB -> enhanced={np.mean(se):.2f} dB")



def cli(argv=None):
    parser = argparse.ArgumentParser(description="Train a fixture-demo model")
    parser.add_argument("model_dir")
    parser.add_argument("budget_s", nargs="?", type=float, default=600.0)
    parser.add_argument("lr", nargs="?", type=float, default=3e-4)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    main(args.model_dir, args.budget_s, args.lr, device=args.device)


if __name__ == "__main__":
    cli()
