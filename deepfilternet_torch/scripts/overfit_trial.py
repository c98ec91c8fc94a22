"""Overfit check on the device: train DFN3 on the fixture corpus.

Proves the whole train -> inference stack on one device: data engine ->
features -> model -> loss stack -> AdamW -> enhancement. DFN3 starts from
`init_model` seed 0 (or resumes from its checkpoint directory, so repeated
runs add steps) and trains on one fixed pool of batches (the loader's
overfit mode) until the time budget is spent; then it writes its checkpoint
(with the optimizer state) and prints the training set's SI-SDR before and
after.

    python -m deepfilternet_torch.scripts.overfit_trial [seconds] [ckpt_dir] \\
        [--assets assets] [--device cpu]

The corpus is `clean.hdf5` and `noise_flac.hdf5` in the assets directory
(default `assets`, relative to the working directory); the checkpoint
directory defaults to `dfn3_trial_ckpt` in the system's temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from deepfilternet_torch.config import config

CKPT_DIR = os.path.join(tempfile.gettempdir(), "dfn3_trial_ckpt")
# the fixture loss stack (the reference's training defaults)
LOSSES = (
    ("SpectralLoss", "factor_magnitude", "100"),
    ("SpectralLoss", "factor_complex", "100"),
    ("SpectralLoss", "gamma", "0.6"),
    ("MaskLoss", "factor", "1"),
    ("LocalSnrLoss", "factor", "0.0005"),
)


def main(budget_s: float = 400.0, ckpt_dir: str = CKPT_DIR, assets_dir: str = "assets",
         device=None) -> None:
    from deepfilternet_torch.checkpoint import (
        optimizer_state_from_numpy,
        params_from_numpy,
        read_cp,
        write_cp,
    )
    from deepfilternet_torch.data.dataloader import DataLoader
    from deepfilternet_torch.data.dataset import FdDataset, Hdf5Cfg, TdDataset
    from deepfilternet_torch.enhance import resolve_device
    from deepfilternet_torch.eval.evaluation import si_sdr_np
    from deepfilternet_torch.models import init_model
    from deepfilternet_torch.ops.erb import erb_widths
    from deepfilternet_torch.ops.stft import Stft, istft
    from deepfilternet_torch.train.loss import Loss
    from deepfilternet_torch.train.run import batch_to_arrays, to_device
    from deepfilternet_torch.train.trainer import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    dev = resolve_device(device)
    config.reset()
    for sec, k, v in LOSSES:
        config.set(k, v, section=sec)

    cfgs = [Hdf5Cfg("clean.hdf5", 16), Hdf5Cfg("noise_flac.hdf5", 1)]
    td = TdDataset(assets_dir, cfgs, "train", max_len_s=3.0, seed=1)
    dl = DataLoader(FdDataset(td), batch_size=8, num_workers=6, overfit=True, drop_last=True)

    params, state, cfg, module = init_model("deepfilternet3", seed=0, device=dev)
    stft_cfg = Stft(48000, 960, 480)
    loss_obj = Loss(stft_cfg, erb_widths(48000, 960, 32, 2), 96, (-15, 35))
    step = make_train_step(module, cfg, loss_obj)
    optimizer = make_optimizer()
    payload = read_cp(ckpt_dir, "latest")
    step0 = 0
    if payload is not None:
        params, state = params_from_numpy(payload["params"], payload["state"], dev)
    ts = init_train_state(params, state, optimizer)
    if payload is not None:
        if "opt_state" in payload:
            ts.opt_state.load_state_dict(optimizer_state_from_numpy(payload["opt_state"]))
        step0 = payload["epoch"]
        print(f"resumed from step {step0}")

    lr, wd = torch.tensor(3e-4), torch.tensor(0.05)
    # a fixed pool of batches (overfit mode), made once
    pool = list(dl.iter_epoch("train", 0))
    arr_pool = [to_device(batch_to_arrays(b), dev) for b in pool]
    t0 = time.time()
    losses = []
    n = step0
    while time.time() - t0 < budget_s:
        for arrays in arr_pool:
            ts, m = step(ts, arrays, lr, wd)
            losses.append(float(m["loss"]))
            n += 1
    elapsed = time.time() - t0
    write_cp(ckpt_dir, ts.params, ts.model_state, n, opt_state=ts.opt_state.state_dict(),
             keep_n=1)
    print(f"steps {step0}->{n}, loss {np.mean(losses[:3]):.3f} -> {np.mean(losses[-3:]):.3f}, "
          f"{(n - step0) / elapsed:.2f} steps/s")

    with torch.no_grad():
        arrays = arr_pool[0]
        (spec_e, _, _, _), _ = module.forward(ts.params, ts.model_state, cfg, arrays["noisy"],
                                              arrays["feat_erb"], arrays["feat_spec"])
        enh = istft(torch.complex(spec_e[..., 0], spec_e[..., 1]), stft_cfg).cpu().numpy()
    batch = pool[0]
    d = 480  # the synthesis delay
    se, sn = [], []
    for i in range(enh.shape[0]):
        t = min(enh.shape[-1], batch.speech.shape[-1])
        se.append(si_sdr_np(enh[i, d:t], batch.speech[i, 0, : t - d]))
        sn.append(si_sdr_np(batch.noisy[i, 0, :t], batch.speech[i, 0, :t]))
    print(f"si_sdr noisy={np.mean(sn):.2f} dB -> enhanced={np.mean(se):.2f} dB")


def cli(argv=None):
    parser = argparse.ArgumentParser(description="Overfit DFN3 on the fixture corpus")
    parser.add_argument("budget_s", nargs="?", type=float, default=400.0)
    parser.add_argument("ckpt_dir", nargs="?", default=CKPT_DIR)
    parser.add_argument("--assets", default="assets", help="the corpus directory")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    main(args.budget_s, args.ckpt_dir, args.assets, device=args.device)


if __name__ == "__main__":
    cli()
