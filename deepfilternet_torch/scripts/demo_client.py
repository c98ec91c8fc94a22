"""Terminal spectrogram demo client: the reference demo app's surface
(live capture, noisy/enhanced spectrogram view, DF on/off toggle) for a
terminal over the stream-server wire protocol. The port of
`deepfilternet_tpu/scripts/demo_client.py`; it speaks to either package's
server.

Streams a wav file (or raw float32 on stdin) hop-by-hop through a running
`python -m deepfilternet_torch.serve` server at real-time pacing and renders
side-by-side noisy | enhanced mel-ish spectrogram columns with unicode shade
blocks, plus the running RTF and round-trip latency.

    python -m deepfilternet_torch.scripts.demo_client noisy.wav [--port 7860]
        [--rows 24] [--no-realtime] [--toggle-every 5.0] [--out out.wav]

`--toggle-every N` alternates enhancement on/off every N seconds (the
demo app's DF toggle) by bypassing the server for the off intervals.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

HOP = 480
SR = 48000
SHADES = " ░▒▓█"


def _spec_column(frame: np.ndarray, rows: int) -> str:
    """One hop -> `rows` characters, log-spaced bands, dB shading."""
    spec = np.abs(np.fft.rfft(frame * np.hanning(len(frame))))
    edges = np.unique(
        np.geomspace(1, len(spec) - 1, rows + 1).astype(int)
    )
    bands = [spec[a:b].max() if b > a else spec[a] for a, b in
             zip(edges[:-1], edges[1:])]
    while len(bands) < rows:
        bands.append(0.0)
    db = 20 * np.log10(np.asarray(bands) + 1e-8)
    lvl = np.clip((db + 70.0) / 70.0, 0.0, 1.0)
    idx = (lvl * (len(SHADES) - 1)).astype(int)
    return "".join(SHADES[i] for i in idx[::-1])


def main(argv=None):
    from deepfilternet_torch.serve import StreamClient
    from deepfilternet_torch.utils.audio_io import load_audio, resample, save_audio

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("wav", help="input wav (use '-' for raw f32 on stdin)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--rows", type=int, default=20)
    ap.add_argument("--no-realtime", action="store_true",
                    help="run as fast as the server allows")
    ap.add_argument("--toggle-every", type=float, default=0.0,
                    help="alternate DF on/off every N seconds")
    ap.add_argument("--out", default=None, help="write enhanced wav here")
    args = ap.parse_args(argv)

    if args.wav == "-":
        raw = sys.stdin.buffer.read()
        audio = np.frombuffer(raw, np.float32)
    else:
        a, sr = load_audio(args.wav)
        if sr != SR:
            a = resample(a, sr, SR)
        audio = np.asarray(a)[0]
    n_hops = len(audio) // HOP
    audio = audio[: n_hops * HOP]

    # no socket deadline: the first reply may wait on a cold server (its
    # kernel build, minutes on a loaded host)
    client = StreamClient(args.host, args.port, timeout=None)
    outs = []
    t_start = time.time()
    busy = 0.0
    df_on = True
    print(f"{'noisy':^{args.rows}} | {'enhanced':^{args.rows}}  "
          f"(DF toggle every {args.toggle_every or 'never'} s)")
    try:
        for i in range(n_hops):
            hop = audio[i * HOP : (i + 1) * HOP]
            if args.toggle_every > 0:
                df_on = int((i * HOP / SR) / args.toggle_every) % 2 == 0
            t0 = time.time()
            enhanced = client.process_frame(hop)
            dt = time.time() - t0
            busy += dt
            shown = enhanced if df_on else hop
            outs.append(np.asarray(shown, np.float32))
            col_n = _spec_column(hop, args.rows)
            col_e = _spec_column(np.asarray(shown), args.rows)
            rtf = (i + 1) * HOP / SR / max(busy, 1e-9)
            sys.stdout.write(
                f"\r{col_n} | {col_e}  df={'on ' if df_on else 'off'} "
                f"rt={dt * 1e3:5.1f}ms rtf={rtf:6.1f}x "
            )
            sys.stdout.flush()
            if not args.no_realtime:
                target = t_start + (i + 1) * HOP / SR
                delay = target - time.time()
                if delay > 0:
                    time.sleep(delay)
    finally:
        client.close()
        print()
    if args.out:
        save_audio(args.out, np.concatenate(outs)[None, :], SR)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
