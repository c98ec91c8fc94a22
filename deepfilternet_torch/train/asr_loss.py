"""ASR (Whisper) perceptual loss, the port's counterpart of
`deepfilternet_tpu.train.asr_loss` (the reference's df/loss.py:419-648).

It distills Whisper's behaviour into training: (1) the MSE between the
Whisper encoder's embeddings of the enhanced and the clean signal, and
(2) a token loss on the decoder's logits: cross entropy against the tokens
greedily decoded from the clean signal (eot carried on), or CTC with the
lengths the first eot gives.

- 48 kHz -> 16 kHz is a kaiser-windowed polyphase FIR written as a strided
  convolution of the zero-stuffed input (JAX's lhs dilation and stride).
- Whisper's log-mel features (n_fft 400, hop 160, 80 slaney-normalized mel
  bands, log10 clamped at 1e-10, floored per sample at its max - 8, then
  (x + 4) / 4) come from a DFT matrix product and a mel matrix product,
  padded or cut to 3000 frames: the torch Whisper encoder refuses any other
  length.
- The Whisper model is transformers' torch `WhisperForConditionalGeneration`.
  The greedy decode of the clean signal runs under `torch.no_grad()` with a
  fixed budget (`sample_len` 25, the reference's max_ctx); the token loss
  then teacher-forces those tokens through the decoder on the *enhanced*
  embeddings in one call.
- The CTC form is optax's `ctc_loss` (per sequence, label paddings, a blank
  id, log epsilon -1e5), written out here: `torch.nn.functional.ctc_loss`
  differs from it where no alignment exists (inf, or 0).

`transformers` is imported only to load a `model` path: the module imports
without it. Pretrained weights are not vendored: a `model` path that does
not exist raises.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5  # optax.ctc_loss's log of zero

# ---------------------------------------------------------------------------
# polyphase FIR resampling as a strided convolution
# ---------------------------------------------------------------------------


def _kaiser_sinc_taps(up: int, down: int, taps_per_phase: int = 16,
                      beta: float = 8.555) -> np.ndarray:
    """Lowpass FIR for rational resampling by up/down (cutoff at the
    narrower Nyquist), kaiser-windowed sinc."""
    cutoff = 0.5 / max(up, down)  # in units of the upsampled rate
    half = taps_per_phase * max(up, down)
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = 2 * cutoff * np.sinc(2 * cutoff * n)
    taps *= np.kaiser(len(n), beta)
    taps *= up / taps.sum() / up  # unity DC gain after upsampling
    return (taps * up).astype(np.float32)


def fir_resample(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """Rational-rate resample [..., T] -> [..., T*sr_out/sr_in]: the input
    zero-stuffed by `up`, padded by half the filter on each side and
    convolved with stride `down`."""
    if sr_in == sr_out:
        return x
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    taps = torch.from_numpy(_kaiser_sinc_taps(up, down)).to(x.device)
    k = taps.numel()
    lead, t = x.shape[:-1], x.shape[-1]
    xx = x.reshape(-1, 1, t)
    if up > 1:
        stuffed = xx.new_zeros((xx.shape[0], 1, (t - 1) * up + 1))
        stuffed[..., ::up] = xx
        xx = stuffed
    y = F.conv1d(F.pad(xx, (k // 2, k // 2)), taps.view(1, 1, k), stride=down)
    return y[:, 0, : (t * up) // down].reshape(*lead, -1)


# ---------------------------------------------------------------------------
# Whisper log-mel features
# ---------------------------------------------------------------------------


def _slaney_mel_fb(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-style mel filterbank [n_fft//2+1, n_mels] (librosa's
    default), the filter family Whisper's preprocessing uses."""
    fmin, fmax = 0.0, sr / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3.0)
        log_region = f >= 1000.0
        return np.where(
            log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4) * 27.0, mel)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3.0)
        log_region = m >= 15.0
        return np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz = mel_to_hz(mels)
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((len(bins), n_mels), dtype=np.float64)
    for i in range(n_mels):
        lo, ctr, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (bins - lo) / max(ctr - lo, 1e-10)
        dn = (hi - bins) / max(hi - ctr, 1e-10)
        fb[:, i] = np.maximum(0.0, np.minimum(up, dn))
        fb[:, i] *= 2.0 / (hi - lo)  # slaney area normalization
    return fb.astype(np.float32)


def _dft_mats(n_fft: int):
    nn, kk = np.arange(n_fft), np.arange(n_fft // 2 + 1)
    ang = 2.0 * np.pi * np.outer(nn, kk) / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def whisper_log_mel(audio16k: torch.Tensor, n_fft: int = 400, hop: int = 160,
                    n_mels: int = 80, chunk_frames: int = 3000) -> torch.Tensor:
    """audio [B, T] at 16 kHz -> Whisper input_features [B, n_mels, 3000]:
    hann window, power of every frame but the trailing one, slaney mel
    filterbank, log10 clamped at 1e-10, floored per sample at its max - 8,
    then (x + 4) / 4. The audio is zero-padded or cut to `chunk_frames`
    frames (30 s)."""
    dev = audio16k.device
    t = audio16k.shape[1]
    want = chunk_frames * hop
    audio16k = audio16k[:, :want] if t >= want else F.pad(audio16k, (0, want - t))
    # reflect-pad half a window on each side (torch.stft's center=True)
    p = n_fft // 2
    xpad = F.pad(audio16k[:, None], (p, p), mode="reflect")[:, 0]
    frames = xpad.unfold(-1, n_fft, hop)[:, :chunk_frames]
    frames = frames * torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(dev)
    cos_m, sin_m = (torch.from_numpy(m).to(dev) for m in _dft_mats(n_fft))
    power = (frames @ cos_m) ** 2 + (frames @ sin_m) ** 2  # [B, F, n_fft//2+1]
    mel = power @ torch.from_numpy(_slaney_mel_fb(16000, n_fft, n_mels)).to(dev)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = torch.amax(log_spec, dim=(1, 2), keepdim=True) - 8.0
    log_spec = (torch.maximum(log_spec, floor) + 4.0) / 4.0
    return log_spec.transpose(1, 2)  # [B, M, F]


# ---------------------------------------------------------------------------
# optax's CTC loss
# ---------------------------------------------------------------------------


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0,
             log_epsilon: float = LOG_EPSILON) -> torch.Tensor:
    """optax.ctc_loss: the negative log likelihood of each sequence's labels
    [B], from logits [B, T, K] (padded steps 1.0 in logit_paddings [B, T])
    and labels [B, N] (padded labels 1.0 in label_paddings [B, N]), by the
    forward algorithm in log space with `log_epsilon` for log(0)."""
    b, _, k = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = n - label_paddings.sum(dim=1).to(torch.int64)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logits.dtype), (0, 1))
    logprobs_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1)  # [T, B, 1]
    one_hot = F.one_hot(labels.to(torch.int64), k).to(logits.dtype)  # [B, N, K]
    logprobs_emit = torch.einsum("btk,bnk->btn", logprobs, one_hot).transpose(0, 1)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)

    phi = torch.full((b, n + 1), log_epsilon, dtype=logits.dtype, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=-1)
    emit = torch.full((b, n), log_epsilon, dtype=logits.dtype, device=logits.device)
    for lp_emit, lp_phi, pad in zip(logprobs_emit, logprobs_phi, logit_paddings.T):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        pad = pad.reshape(b, 1).to(logits.dtype)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -torch.gather(last, 1, labellens[:, None])[:, 0]


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


class ASRLoss:
    """Whisper-distillation loss (the reference's df/loss.py:419-648).

    factor    -- weight of the encoder-embedding MSE.
    factor_lm -- weight of the token loss on the decoder's logits.
    loss_lm   -- "CrossEntropy" (default) or "CTC" (optax's form).
    model     -- local path of transformers torch Whisper weights
                 (`from_pretrained`); a missing path raises.
    whisper_model -- a constructed torch `WhisperForConditionalGeneration`
                 (the tests carry a tiny Flax one's weights into it).
    initial_tokens -- the decoder prompt; default the model's
                 decoder_start_token_id and any forced_decoder_ids.
    blank_id  -- CTC's blank (Whisper's token for " ").
    """

    target_sr = 16000
    n_fft = 400
    hop = 160
    n_mels = 80
    sample_len = 25  # the reference's max_ctx

    def __init__(
        self,
        sr: int,
        factor: float = 1.0,
        factor_lm: float = 1.0,
        loss_lm: str = "CrossEntropy",
        model: str = "",
        whisper_model=None,
        initial_tokens: Optional[Sequence[int]] = None,
        blank_id: int = 220,
    ) -> None:
        if loss_lm not in ("CrossEntropy", "CTC"):
            raise ValueError(f"loss_lm must be CrossEntropy or CTC, got {loss_lm!r}")
        self.sr = sr
        self.factor = float(factor)
        self.factor_lm = float(factor_lm)
        self.loss_lm = loss_lm
        self.blank_id = blank_id
        if whisper_model is None:
            if not model or not os.path.exists(model):
                raise NotImplementedError(
                    "ASRLoss needs local torch Whisper weights "
                    "(config ASRLoss.MODEL=/path/to/whisper); pretrained "
                    "weights are not vendored (reference df/loss.py:419-648).")
            from transformers import WhisperForConditionalGeneration

            whisper_model = WhisperForConditionalGeneration.from_pretrained(model)
        # no dropout, and Whisper's own weights are not trained
        self.whisper = whisper_model.eval().requires_grad_(False)
        cfg = whisper_model.config
        if initial_tokens is None:
            initial_tokens = [cfg.decoder_start_token_id]
            forced = getattr(cfg, "forced_decoder_ids", None) or []
            initial_tokens += [tok for _, tok in forced]
        self.initial_tokens = tuple(int(t) for t in initial_tokens)
        self.eot = int(cfg.eos_token_id)

    # -- whisper plumbing ---------------------------------------------------

    def _embed(self, audio_td: torch.Tensor) -> torch.Tensor:
        a16 = fir_resample(audio_td, self.sr, self.target_sr)
        feats = whisper_log_mel(a16, self.n_fft, self.hop, self.n_mels)
        return self.whisper.model.encoder(input_features=feats).last_hidden_state

    def _logits(self, ids: torch.Tensor, enc_hidden: torch.Tensor) -> torch.Tensor:
        h = self.whisper.model.decoder(input_ids=ids,
                                       encoder_hidden_states=enc_hidden).last_hidden_state
        return self.whisper.proj_out(h)

    @torch.no_grad()
    def _greedy_tokens(self, enc_hidden: torch.Tensor) -> torch.Tensor:
        """Greedy decode with a fixed budget: [B, sample_len] tokens, eot
        carried on once emitted."""
        b, dev = enc_hidden.shape[0], enc_hidden.device
        n0 = len(self.initial_tokens)
        ids = torch.full((b, n0 + self.sample_len), self.eot, dtype=torch.int64, device=dev)
        ids[:, :n0] = torch.tensor(self.initial_tokens, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        for i in range(self.sample_len):
            pos = n0 + i - 1  # the logits at the last committed token
            nxt = torch.argmax(self._logits(ids, enc_hidden)[:, pos], dim=-1)
            nxt = torch.where(done, torch.full_like(nxt, self.eot), nxt)
            ids[:, pos + 1] = nxt
            done = done | (nxt == self.eot)
        return ids[:, n0:]

    # -- public -------------------------------------------------------------

    def __call__(self, enhanced_td: torch.Tensor, clean_td: torch.Tensor) -> torch.Tensor:
        emb_e = self._embed(enhanced_td)
        with torch.no_grad():
            emb_c = self._embed(clean_td)
        loss = emb_e.new_zeros(())
        if self.factor > 0:
            loss = loss + torch.mean((emb_e - emb_c) ** 2) * self.factor
        if self.factor_lm > 0:
            tokens_c = self._greedy_tokens(emb_c)  # [B, S]
            n0, b = len(self.initial_tokens), tokens_c.shape[0]
            init = torch.tensor(self.initial_tokens, device=tokens_c.device).expand(b, n0)
            dec_in = torch.cat([init, tokens_c], dim=1)[:, :-1]
            # the predictions of the sampled positions
            logits = self._logits(dec_in, emb_e)[:, n0 - 1:]
            if self.loss_lm == "CrossEntropy":
                logp = torch.log_softmax(logits, dim=-1)
                nll = -torch.gather(logp, -1, tokens_c[..., None])[..., 0]
                loss = loss + torch.mean(nll) * self.factor_lm
            else:
                eot = torch.cat([tokens_c == self.eot,
                                 torch.ones((b, 1), dtype=torch.bool, device=tokens_c.device)], 1)
                lengths = torch.argmax(eot.to(torch.int64), dim=1)
                label_pad = (torch.arange(tokens_c.shape[1], device=tokens_c.device)[None, :]
                             >= lengths[:, None]).to(logits.dtype)
                logit_pad = logits.new_zeros(logits.shape[:2])
                ctc = ctc_loss(logits, logit_pad, tokens_c, label_pad, blank_id=self.blank_id)
                loss = loss + torch.mean(ctc) * self.factor_lm
        return loss
