"""Training entry point (reference: df/train.py:47-321), the port's copy of
`deepfilternet_tpu.train.run`.

`python -m deepfilternet_torch.train.run data.cfg data_dir base_dir` trains
the configured model with the reference's training-loop semantics: cosine
lr/wd schedules applied per iteration, NaN-skip guard with MAX_NANS limit,
checkpoint write per epoch with best tracking + early-stopping patience,
SIGUSR1 -> `continue` file for cluster resubmission, deterministic
epoch-seeded data, final test epoch.

The data engine (`data/`) builds each batch on the host in numpy, as in the
JAX package; the batch goes to the device as tensors, where the model, the
losses and the optimizer run (`train/trainer.py`). The evaluation forward
runs under `torch.no_grad()`. `train(device=None)` trains on the CUDA device
and raises without one; pass `device="cpu"` (`--device cpu`) for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import time
from typing import Dict, Optional

import numpy as np
import torch

from deepfilternet_torch.checkpoint import (
    check_patience,
    log_best,
    params_from_numpy,
    read_best,
    read_cp,
    write_cp,
)
from deepfilternet_torch.config import Csv, config
from deepfilternet_torch.data.dataloader import DataLoader
from deepfilternet_torch.data.dataset import DatasetConfig, FdDataset, TdDataset
from deepfilternet_torch.enhance import resolve_device
from deepfilternet_torch.models import init_model
from deepfilternet_torch.ops.stft import Stft, istft
from deepfilternet_torch.train.loss import Loss
from deepfilternet_torch.train.lr import cosine_scheduler
from deepfilternet_torch.utils.timings import GLOBAL_TIMINGS, log_timings_enabled
from deepfilternet_torch.train.trainer import (
    MAX_NANS,
    init_train_state,
    load_opt_config,
    make_optimizer,
    make_train_step,
    trainable_filter,
)

should_stop = False


def _dump_nan_batch(base_dir, batch, epoch, bi, sr):
    from deepfilternet_torch.utils.audio_io import save_audio

    out = os.path.join(base_dir, "summaries", "nan")
    os.makedirs(out, exist_ok=True)
    for i in range(min(batch.noisy.shape[0], 4)):
        save_audio(os.path.join(out, f"e{epoch}_b{bi}_{i}_noisy.wav"),
                   batch.noisy[i], sr)
        save_audio(os.path.join(out, f"e{epoch}_b{bi}_{i}_clean.wav"),
                   batch.speech[i], sr)


def best_and_patience(ckpt_dir: str, epoch: int, valid_loss: float, patience: int):
    """(is_best, go_on) after an epoch: the loss is held against the best of
    the earlier epochs, first by `check_patience` (the count resets on an
    epoch that beats them all and rises on one that does not), then by the
    best log, which a best epoch joins (df/train.py: best-if-improved, then
    patience against the earlier best)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    best = read_best(ckpt_dir)
    is_best = best is None or valid_loss < best[1]
    go_on = check_patience(ckpt_dir, patience, valid_loss, maximize=False)
    if is_best:
        log_best(ckpt_dir, epoch, valid_loss)
    return is_best, go_on


def _complex(ri: torch.Tensor) -> torch.Tensor:
    return torch.complex(ri[..., 0], ri[..., 1])


def _write_audio_summaries(base_dir, loader, eval_fn, ts, stft_cfg, epoch, sr, device,
                           n_samples: int = 2):
    """Periodic epoch summaries on a validation batch (train.py:556-593
    analog): (noisy, clean, enhanced) wavs via synthesis, the per-frame
    LSNR prediction as txt, and spectrogram figures for each signal
    (visualization.py:8-128) where matplotlib is installed."""
    from deepfilternet_torch.utils.audio_io import save_audio

    out_dir = os.path.join(base_dir, "summaries", f"epoch_{epoch}")
    try:
        batch = next(iter(loader.iter_epoch("valid", epoch)))
    except StopIteration:
        return
    os.makedirs(out_dir, exist_ok=True)
    arrays = to_device(batch_to_arrays(batch), device)
    spec_e, _, lsnr, _ = eval_fn(ts.params, ts.model_state, arrays)
    enh = istft(_complex(spec_e), stft_cfg).cpu().numpy()
    lsnr = lsnr.cpu().numpy()
    try:
        from deepfilternet_torch.utils.visualization import spec_figure
        import matplotlib  # noqa: F401
    except ImportError:
        spec_figure = None
    for i in range(min(n_samples, batch.noisy.shape[0])):
        snr = int(batch.snr[i])
        save_audio(os.path.join(out_dir, f"{i}_noisy_snr{snr}.wav"),
                   batch.noisy[i], sr)
        save_audio(os.path.join(out_dir, f"{i}_clean_snr{snr}.wav"),
                   batch.speech[i], sr)
        save_audio(os.path.join(out_dir, f"{i}_enh_snr{snr}.wav"), enh[i], sr)
        np.savetxt(os.path.join(out_dir, f"{i}_lsnr_snr{snr}.txt"),
                   lsnr[i].reshape(-1), fmt="%.3f")
        if spec_figure is not None:
            hop = stft_cfg.hop_size
            for name, spec in (
                ("noisy", arrays["noisy"][i]),
                ("clean", arrays["clean"][i]),
                ("enh", spec_e[i]),
            ):
                c = _complex(spec).cpu().numpy()  # [T, F]
                spec_figure(c, sr=sr, hop=hop, title=f"{name} (snr {snr} dB)",
                            path=os.path.join(out_dir, f"{i}_{name}_spec.png"))


def _sigusr1(signum, frame):
    global should_stop
    should_stop = True


def batch_to_arrays(batch) -> Dict[str, np.ndarray]:
    """Batch -> model inputs. Spectral fields are [B, C, T, F]; the models
    consume one channel per example (reference modules take conv in_ch=1,
    df/modules.py:49-67), so channels fold into the batch axis: [B*C, T, F].
    Mono corpora (C=1) reduce to the plain [B, T, F] path."""

    def fold(x):
        return x.reshape(-1, *x.shape[2:]) if x.ndim >= 3 else x

    def ri(x):
        x = fold(x)
        return np.stack([x.real, x.imag], axis=-1).astype(np.float32)

    return {
        "noisy": ri(batch.spec_noisy),
        "clean": ri(batch.spec_clean),
        "feat_erb": fold(batch.feat_erb),
        "feat_spec": ri(batch.feat_spec),
    }


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """`batch_to_arrays`' output as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def train(
    data_cfg_path: str,
    data_dir: str,
    base_dir: str,
    max_epochs: Optional[int] = None,
    num_workers: int = 4,
    debug: bool = False,
    device=None,
):
    global should_stop
    dev = resolve_device(device)
    # a SIGUSR1 that stopped an earlier train() in this process does not stop
    # this one (the JAX package keeps the flag set)
    should_stop = False
    os.makedirs(base_dir, exist_ok=True)
    ckpt_dir = os.path.join(base_dir, "checkpoints")
    cfg_path = os.path.join(base_dir, "config.ini")
    config.reset()
    config.load(cfg_path if os.path.isfile(cfg_path) else None, allow_reload=True)

    seed = config("SEED", 42, int, section="train")
    model_name = config("MODEL", "deepfilternet3", str, section="train")
    epochs = max_epochs or config("MAX_EPOCHS", 10, int, section="train")
    batch_size = config("BATCH_SIZE", 8, int, section="train")
    # host-specific batch-size override (train.py:97-109 /
    # scripts/set_batch_size.py analog): base_dir/batch_size_by_host.json
    # maps hostname -> batch size
    bs_by_host = os.path.join(base_dir, "batch_size_by_host.json")
    if os.path.isfile(bs_by_host):
        with open(bs_by_host) as f:
            host_bs = json.load(f).get(socket.gethostname())
        if host_bs:
            print(f"Host batch-size override: {host_bs}")
            batch_size = int(host_bs)
    batch_size_eval = config("BATCH_SIZE_EVAL", batch_size, int, section="train")
    max_sample_len_s = config("MAX_SAMPLE_LEN_S", 5.0, float, section="train")
    patience = config("EARLY_STOPPING_PATIENCE", 5, int, section="train")
    overfit = config("OVERFIT", False, bool, section="train")
    p_reverb = config("p_reverb", 0.0, float, section="distortion")

    bs_sched_raw = config("BATCH_SIZE_SCHEDULING", (), Csv(str), section="train")
    bs_sched = [tuple(int(v) for v in item.split("/")) for item in bs_sched_raw if item]
    if bs_sched:
        assert bs_sched[0][0] == 0, "first scheduling epoch must be 0"

    try:
        signal.signal(signal.SIGUSR1, _sigusr1)
    except ValueError:
        pass  # not on main thread (tests)

    params, model_state, cfg, module = init_model(model_name, seed=seed, device=dev)
    # MASK_ONLY trains the model with the DF stage disabled (reference
    # df/train.py:123-130 constructs run_df=False and excludes the DF
    # decoder from the optimizer, df/train.py:486-494); DF_ONLY is the
    # converse fine-tune mode.
    mask_only = config("MASK_ONLY", False, bool, section="train")
    df_only = config("DF_ONLY", False, bool, section="train")
    if mask_only:
        cfg = dict(cfg, run_df=False)
    sr = config("SR", 48000, int, section="DF")
    fft_size = config("FFT_SIZE", 960, int, section="DF")
    hop_size = config("HOP_SIZE", 480, int, section="DF")
    stft_cfg = Stft(sr=sr, fft_size=fft_size, hop_size=hop_size)
    loss_obj = Loss(stft_cfg, cfg["erb_widths"], cfg["nb_df"], (cfg["lsnr_min"], cfg["lsnr_max"]))

    # data
    ds_cfg = DatasetConfig.open(data_cfg_path)
    loaders = {}
    for split in ("train", "valid", "test"):
        td = TdDataset(
            data_dir, ds_cfg.split(split), split, sr=sr,
            max_len_s=max_sample_len_s, p_reverb=p_reverb, seed=seed,
        )
        fd = FdDataset(td, fft_size, hop_size, cfg["nb_erb"], cfg["nb_df"])
        loaders[split] = DataLoader(
            fd, batch_size, num_workers=num_workers, overfit=overfit,
            batch_size_eval=batch_size_eval, drop_last=(split == "train"),
        )

    opt_cfg = load_opt_config()
    optimizer = make_optimizer(opt_cfg)
    step_fn = make_train_step(module, cfg, loss_obj,
                              trainable=trainable_filter(mask_only, df_only))

    # resume: the checkpoint's weights, a fresh optimizer state
    start_epoch = 0
    payload = read_cp(ckpt_dir, "latest")
    if payload is not None:
        params, model_state = params_from_numpy(payload["params"], payload["state"], dev)
        start_epoch = payload["epoch"] + 1
        print(f"Resuming from epoch {payload['epoch']}")
    ts = init_train_state(params, model_state, optimizer)

    niter = loaders["train"].len_of("train")

    def lr_schedule(niter):
        return cosine_scheduler(
            opt_cfg["lr"], opt_cfg["lr_min"], epochs, niter,
            warmup_epochs=opt_cfg["warmup_epochs"], start_warmup_value=opt_cfg["lr_warmup"],
            initial_ep_per_cycle=opt_cfg["lr_cycle_epochs"],
            cycle_decay=opt_cfg["lr_cycle_decay"], cycle_mul=opt_cfg["lr_cycle_mul"],
        )

    lr_sched = lr_schedule(niter)
    wd_end = opt_cfg["weight_decay_end"]
    wd_sched = (
        cosine_scheduler(opt_cfg["weight_decay"], wd_end, epochs, niter)
        if wd_end >= 0 else None
    )
    config.save(cfg_path)

    def eval_fn(params, state, batch):
        with torch.no_grad():
            return module.forward(params, state, cfg, batch["noisy"], batch["feat_erb"],
                                  batch["feat_spec"], train=False)[0]

    def run_eval(split: str, epoch: int) -> float:
        losses = []
        for batch in loaders[split].iter_epoch(split, epoch):
            arrays = to_device(batch_to_arrays(batch), dev)
            spec_e, m, lsnr, _ = eval_fn(ts.params, ts.model_state, arrays)
            with torch.no_grad():
                total, _ = loss_obj(_complex(arrays["clean"]), _complex(arrays["noisy"]),
                                    _complex(spec_e), m, lsnr)
            losses.append(float(total))
        return float(np.mean(losses)) if losses else float("inf")

    prev_sched_bs = None
    for epoch in range(start_epoch, epochs):
        if bs_sched:
            # batch-size scheduling (train.py:234-246): largest entry whose
            # epoch <= current, capped by the configured batch size
            sched_bs = batch_size
            for e_from, b in bs_sched:
                if e_from <= epoch:
                    sched_bs = min(b, batch_size)
            if sched_bs != prev_sched_bs:
                print(f"Batch scheduling | batch size {sched_bs}")
                loaders["train"].set_batch_size(sched_bs, "train")
                niter = loaders["train"].len_of("train")
                lr_sched = lr_schedule(niter)
                prev_sched_bs = sched_bs
        t0 = time.time()
        n_steps = 0
        loss_sum = 0.0
        for bi, batch in enumerate(loaders["train"].iter_epoch("train", epoch)):
            it = min(epoch * niter + bi, len(lr_sched) - 1)
            # the schedules' values rounded to float32, as JAX hands them over
            lr = float(np.float32(lr_sched[it]))
            wd = float(np.float32(wd_sched[it] if wd_sched is not None
                                  else opt_cfg["weight_decay"]))
            ts, metrics = step_fn(ts, to_device(batch_to_arrays(batch), dev), lr, wd)
            loss_sum += float(metrics["loss"])
            n_steps += 1
            if not bool(metrics["finite"]):
                # dump the offending batch audio (train.py:392-419 analog)
                _dump_nan_batch(base_dir, batch, epoch, bi, sr)
            if ts.nan_count > MAX_NANS:
                raise RuntimeError(f"Too many NaNs ({ts.nan_count}), aborting")
            if debug and bi >= 2:
                break
        train_loss = loss_sum / max(n_steps, 1)
        print(f"epoch {epoch}: train loss {train_loss:.4f} "
              f"({n_steps} steps, {time.time() - t0:.1f}s, lr {lr:.2e})")

        _write_audio_summaries(base_dir, loaders["valid"], eval_fn, ts, stft_cfg,
                               epoch, sr, dev)
        valid_loss = run_eval("valid", epoch)
        print(f"epoch {epoch}: valid loss {valid_loss:.4f}")
        if log_timings_enabled():
            print(f"epoch {epoch}: timings {GLOBAL_TIMINGS.summary()}")
            GLOBAL_TIMINGS.reset()
        is_best, go_on = best_and_patience(ckpt_dir, epoch, valid_loss, patience)
        write_cp(ckpt_dir, ts.params, ts.model_state, epoch, opt_state=None,
                 is_best=is_best)
        if not go_on:
            print("Early stopping triggered")
            break
        if should_stop:
            with open(os.path.join(base_dir, "continue"), "w") as f:
                f.write(str(epoch))
            print("SIGUSR1 received; wrote continue file")
            break

    test_loss = run_eval("test", 0)
    print(f"final test loss {test_loss:.4f}")
    return ts, test_loss


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a DeepFilterNet model")
    parser.add_argument("data_config")
    parser.add_argument("data_dir")
    parser.add_argument("base_dir")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    train(args.data_config, args.data_dir, args.base_dir,
          max_epochs=args.max_epochs, num_workers=args.num_workers, debug=args.debug,
          device=args.device)


if __name__ == "__main__":
    main()
