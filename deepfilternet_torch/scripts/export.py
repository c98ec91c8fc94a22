"""Export a trained model as a deployable artifact.

The archive holds (a) the checkpoints, (b) `config.ini` and (c) two
`torch.export` programs, the offline forward (`offline.pt2`) and the
streaming cell (`streaming_cell.pt2`), serialized with `torch.export.save`:
programs that run without the Python model code, on the device they were
exported on. The layout is the JAX package's (`scripts/export.py`, whose
programs are StableHLO), so either package's `init_df` reads the
checkpoints of an archive made with `--skip-hlo`.

DFN3, DFN2 and DFN1 export; DeepFilterNet-MF has no streaming cell and
raises.

Usage:
    python -m deepfilternet_torch.scripts.export base_dir out.tar.gz \\
        [--epoch best] [--skip-hlo] [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import os
import tarfile

import torch
from torch.utils import _pytree as pytree

from deepfilternet_torch import __version__

class _Program(torch.nn.Module):
    """A function of tensors as the module `torch.export` takes; the model's
    parameters are the function's constants."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _serialized(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_programs(model, df_state, batch: int = 1, time: int = 10) -> dict:
    """{"offline.pt2": bytes, "streaming_cell.pt2": bytes}: the offline
    forward over [batch, time] frames (outputs spec_e, mask, lsnr) and the
    streaming cell over one frame, the model carry's leaves first in its
    inputs and outputs; float32, traced on the model's device."""
    module, cfg, dev = model.module, model.cfg, model.device
    # each constant of the programs in a storage of its own (a leaf read
    # from a checkpoint may view a larger buffer, which the archive writer
    # cannot place)
    params, state = pytree.tree_map(torch.clone, (model.params, model.state))
    if not hasattr(module, "streaming_cell"):
        raise NotImplementedError(
            f"{getattr(module, '__name__', type(module).__name__)} has no streaming cell "
            "to export (DFN3, DFN2 and DFN1 export)")
    f, e, fp = cfg["freq_bins"], cfg["nb_erb"], cfg["nb_df"]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def offline(spec, fe, fs):
        (spec_e, m, lsnr, _), _ = module.forward(params, state, cfg, spec, fe, fs)
        return spec_e, m, lsnr

    carry0 = module.streaming_init(batch, cfg, device=dev)
    n = len(carry0)

    def cell(*args):
        # the carry goes in and out as its leaves: a program's signature
        # holds tensors and tuples, not the model's NamedTuple
        carry, out = module.streaming_cell(params, state, cfg,
                                           type(carry0)(*args[:n]), *args[n:])
        return (*carry, *out)

    with torch.no_grad():
        off = torch.export.export(
            _Program(offline), (zeros(batch, time, f, 2), zeros(batch, time, e),
                                zeros(batch, time, fp, 2)))
        step = torch.export.export(
            _Program(cell), (*carry0, zeros(batch, f, 2), zeros(batch, e), zeros(batch, fp, 2)))
    return {"offline.pt2": _serialized(off), "streaming_cell.pt2": _serialized(step)}


def export_model(base_dir: str, output: str, epoch="best", skip_hlo: bool = False,
                 device=None):
    """Write the archive of the model in `base_dir` (at `epoch`) to `output`;
    `skip_hlo` leaves the programs out (the JAX CLI's name for it). The
    programs are traced on `device` (default: the CUDA device)."""
    from deepfilternet_torch.enhance import init_df

    model, df_state, suffix = init_df(base_dir, epoch=epoch, device=device)
    artifacts = {} if skip_hlo else export_programs(model, df_state)
    with tarfile.open(output, "w:gz") as tar:

        def add_bytes(name, data: bytes):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))

        cfg_path = os.path.join(base_dir, "config.ini")
        if os.path.isfile(cfg_path):
            tar.add(cfg_path, arcname="config.ini")
        ckpt_dir = os.path.join(base_dir, "checkpoints")
        if os.path.isdir(ckpt_dir):
            for name in sorted(os.listdir(ckpt_dir)):
                if name.startswith("model_"):
                    tar.add(os.path.join(ckpt_dir, name), arcname=f"checkpoints/{name}")
        for name, data in artifacts.items():
            add_bytes(name, data)
        add_bytes("version.txt", f"deepfilternet_torch-{__version__}\n".encode())
    print(f"Exported {suffix} to {output}")


def load_exported(path: str, name: str = "offline.pt2"):
    """The program `name` of the archive at `path` as a callable: the
    offline one takes (spec [B, T, F, 2], feat_erb [B, T, E], feat_spec
    [B, T, F', 2]) and returns (spec_e, mask, lsnr); the cell takes (carry,
    spec [B, F, 2], feat_erb [B, E], feat_spec [B, F', 2]) and returns
    (carry', (spec_e, lsnr, mask)), as `streaming_cell` does."""
    with tarfile.open(path, "r:gz") as tar:
        data = tar.extractfile(name).read()
    program = torch.export.load(io.BytesIO(data)).module()
    if name != "streaming_cell.pt2":
        return program

    def cell(carry, spec, feat_erb, feat_spec):
        out = program(*carry, spec, feat_erb, feat_spec)
        return type(carry)(*out[:len(carry)]), tuple(out[len(carry):])

    return cell


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export a model artifact")
    parser.add_argument("base_dir")
    parser.add_argument("output")
    parser.add_argument("--epoch", default="best")
    parser.add_argument("--skip-hlo", action="store_true",
                        help="archive the checkpoints and config without the programs")
    parser.add_argument("--device", default=None,
                        help="device to trace the programs on (default: the CUDA device)")
    args = parser.parse_args(argv)
    export_model(args.base_dir, args.output, epoch=args.epoch, skip_hlo=args.skip_hlo,
                 device=args.device)


if __name__ == "__main__":
    main()
