"""The port's ASRLoss (`deepfilternet_torch/train/asr_loss.py`) against the
JAX package's, on the CPU.

A tiny randomly initialized Whisper (the config of `tests/test_asr_loss.py`):
JAX's Flax model, and the same weights carried into transformers' torch
`WhisperForConditionalGeneration` inside the test
(`load_flax_weights_in_pytorch_model`, no download). Held, each as a share
of JAX's largest value unless said otherwise:

  * `fir_resample` (48 -> 16 kHz and 16 -> 48 kHz) within 1e-6;
  * `whisper_log_mel` within 1e-5;
  * the greedy decode: the same tokens from the same embeddings;
  * the loss (encoder MSE, CrossEntropy, CTC) within 1e-4 relative, and its
    gradient with respect to the enhanced audio within 1e-3 (CTC: 1e-2, see
    `CTC_GRAD`);
  * `Loss` with a Whisper model adds the "asr" part, as JAX's;
  * CTC is optax's, also where no alignment exists (optax's finite value);
  * the module imports without `transformers`.
"""

import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from _torch_families import REPO  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.train import asr_loss as ja  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.train import asr_loss as ta  # noqa: E402

RESAMPLE, LOG_MEL, LOSS_REL, GRAD = 1e-6, 1e-5, 1e-4, 1e-3
# The tiny random Whisper decodes 25 repeats of one token, which no CTC
# alignment of 25 steps can emit: the loss is then optax's log epsilon
# (~1e5), where a float32 logaddexp resolves 8e-3. At the test's logits
# optax's float32 gradient lies 9.7e-3 (of the largest) from the same
# algorithm in float64, the port's 2.7e-4 (`test_ctc_gradient_...`); through
# the decoder to the audio the two packages differ by 3.4e-3.
CTC_GRAD = 1e-2
KINDS = {"mse": dict(factor=1.0, factor_lm=0.0),
         "ce": dict(factor=0.0, factor_lm=1.0),
         "ctc": dict(factor=0.0, factor_lm=1.0, loss_lm="CTC")}


@pytest.fixture(scope="module", autouse=True)
def _fresh_configs():
    j_config.reset()
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    j_config.reset()
    t_config.reset()


@pytest.fixture(scope="module")
def whispers():
    """(Flax tiny Whisper, torch tiny Whisper with the same weights)."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model
    from transformers.models.whisper.modeling_flax_whisper import (
        FlaxWhisperForConditionalGeneration,
    )

    cfg = WhisperConfig(
        vocab_size=64, num_mel_bins=80, d_model=32,
        encoder_layers=1, encoder_attention_heads=2,
        decoder_layers=1, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_source_positions=1500, max_target_positions=64,
        decoder_start_token_id=1, eos_token_id=2, pad_token_id=2,
    )
    flax = FlaxWhisperForConditionalGeneration(cfg, seed=0)
    cfg._attn_implementation = "eager"
    tm = load_flax_weights_in_pytorch_model(WhisperForConditionalGeneration(cfg), flax.params)
    tm.tie_weights()  # the logits head is the token embedding, as Flax's
    return flax, tm.eval()


def _rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _audio(seed=1, n=48000):
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((2, n)).astype(np.float32) * 0.1
    enh = clean + rng.standard_normal((2, n)).astype(np.float32) * 0.02
    return enh, clean


@pytest.mark.parametrize("sr_in, sr_out", [(48000, 16000), (16000, 48000), (48000, 32000)])
def test_fir_resample_matches_jax(sr_in, sr_out):
    x = np.random.default_rng(0).standard_normal((2, 3, 4800)).astype(np.float32)
    got = ta.fir_resample(torch.from_numpy(x), sr_in, sr_out)
    assert _rel(got, ja.fir_resample(jnp.asarray(x), sr_in, sr_out)) <= RESAMPLE
    same = torch.from_numpy(x)
    assert ta.fir_resample(same, 16000, 16000) is same


@pytest.mark.parametrize("seconds", [1.0, 31.0])
def test_whisper_log_mel_matches_jax(seconds):
    """Padded (1 s) and cut (31 s) to 3000 frames."""
    a = np.random.default_rng(2).standard_normal((2, int(16000 * seconds))).astype(np.float32)
    got = ta.whisper_log_mel(torch.from_numpy(a * 0.1))
    assert got.shape == (2, 80, 3000)
    assert _rel(got, ja.whisper_log_mel(jnp.asarray(a * 0.1))) <= LOG_MEL


def test_greedy_decode_equals_jax(whispers):
    """The same tokens from the same clean embeddings (JAX's)."""
    flax, tm = whispers
    _, clean = _audio()
    jl = ja.ASRLoss(48000, whisper_model=flax, blank_id=3)
    tl = ta.ASRLoss(48000, whisper_model=tm, blank_id=3)
    emb = jl._embed(jnp.asarray(clean))
    assert _rel(tl._embed(torch.from_numpy(clean)), emb) <= LOSS_REL
    ref = np.asarray(jl._greedy_tokens(emb))
    got = tl._greedy_tokens(torch.from_numpy(np.asarray(emb))).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (2, ta.ASRLoss.sample_len)


@pytest.mark.parametrize("kind", list(KINDS))
def test_loss_and_gradient_match_jax(whispers, kind):
    flax, tm = whispers
    enh, clean = _audio()
    jl = ja.ASRLoss(48000, whisper_model=flax, blank_id=3, **KINDS[kind])
    val, grad = jax.jit(jax.value_and_grad(lambda e: jl(e, jnp.asarray(clean))))(
        jnp.asarray(enh))
    tl = ta.ASRLoss(48000, whisper_model=tm, blank_id=3, **KINDS[kind])
    e = torch.from_numpy(enh).requires_grad_(True)
    got = tl(e, torch.from_numpy(clean))
    (g,) = torch.autograd.grad(got, e)
    assert np.isfinite(float(val)) and float(val) > 0
    assert abs(float(got.detach()) - float(val)) <= LOSS_REL * abs(float(val))
    assert _rel(g, grad) <= (CTC_GRAD if kind == "ctc" else GRAD)


def test_ctc_is_optax_where_no_alignment_exists():
    """Labels that repeat more often than the steps allow: optax's loss is
    finite (log epsilon), torch's own CTC is not; the port's is optax's."""
    import optax

    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 6, 5)).astype(np.float32)
    labels = np.array([[1, 1, 1, 1, 2, 2], [3, 4, 3, 0, 0, 0]], np.int32)
    label_pad = np.array([[0] * 6, [0, 0, 0, 1, 1, 1]], np.float32)
    logit_pad = np.zeros((2, 6), np.float32)
    logit_pad[1, 5] = 1.0
    ref = np.asarray(optax.ctc_loss(logits, logit_pad, labels, label_pad, blank_id=0))
    got = ta.ctc_loss(*map(torch.from_numpy, (logits, logit_pad, labels, label_pad)),
                      blank_id=0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    assert ref[0] > 1e4  # no alignment: log epsilon


def _ctc_grad(logits, labels, label_pad, dtype):
    x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    v = ta.ctc_loss(x, torch.zeros(x.shape[:2], dtype=dtype), torch.from_numpy(labels),
                    torch.from_numpy(label_pad).to(dtype), blank_id=3).mean()
    return torch.autograd.grad(v, x)[0].double().numpy()


@pytest.mark.parametrize("aligned", [True, False])
def test_ctc_gradient_matches_optax_and_float64(aligned):
    """The CTC gradient against optax's where an alignment exists (1e-3 of
    the largest), and against its own float64 evaluation where none does
    (log epsilon: 1e-3, which optax's float32 form does not meet)."""
    import optax

    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((2, 25, 64)) * 3).astype(np.float32)
    labels = (np.full((2, 25), 7) if not aligned else rng.integers(4, 64, (2, 25))).astype(np.int32)
    lens = np.array([10, 12])
    label_pad = (np.arange(25)[None] >= lens[:, None]).astype(np.float32)
    got = _ctc_grad(logits, labels, label_pad, torch.float32)
    if aligned:
        ref = np.asarray(jax.grad(lambda x: jnp.mean(optax.ctc_loss(
            x, jnp.zeros((2, 25)), labels, label_pad, blank_id=3)))(jnp.asarray(logits)))
    else:
        ref = _ctc_grad(logits, labels, label_pad, torch.float64)
    assert _rel(got, ref) <= GRAD


def test_loss_aggregator_wires_asr(whispers):
    from deepfilternet_tpu.ops import Stft as JStft
    from deepfilternet_tpu.ops import stft as j_stft
    from deepfilternet_tpu.train.loss import Loss as JLoss
    from deepfilternet_torch.ops.stft import Stft, stft
    from deepfilternet_torch.train.loss import Loss

    flax, tm = whispers
    rng = np.random.default_rng(2)
    clean = rng.standard_normal((1, 48000)).astype(np.float32) * 0.1
    noisy = clean + 0.05
    parts = {}
    for name, config, loss_cls, spec, st, model, wrap in (
            ("jax", j_config, JLoss, j_stft, JStft, flax, jnp.asarray),
            ("torch", t_config, Loss, stft, Stft, tm, torch.from_numpy)):
        config.reset()
        config.set("factor", "1.0", section="ASRLoss")
        config.set("factor_lm", "0.0", section="ASRLoss")
        try:
            p = st(48000, 960, 480)
            agg = loss_cls(p, (2,) * 32, 96, (-15.0, 35.0), asr_model=model)
            sc, sn = spec(wrap(clean), p), spec(wrap(noisy), p)
            mask = np.ones(tuple(sc.shape[:-1]) + (32,), np.float32) * 0.5
            lsnr = np.zeros(tuple(sc.shape[:-1]) + (1,), np.float32)
            total, parts[name] = agg(sc, sn, sn, wrap(mask), wrap(lsnr))
            assert np.isfinite(float(total))
        finally:
            config.reset()
    assert set(parts["torch"]) == set(parts["jax"]) and "asr" in parts["torch"]
    ref = float(parts["jax"]["asr"])
    assert abs(float(parts["torch"]["asr"]) - ref) <= LOSS_REL * abs(ref)


def test_refusals(whispers):
    with pytest.raises(NotImplementedError, match="Whisper"):
        ta.ASRLoss(48000, model="/nonexistent/path")
    with pytest.raises(ValueError, match="loss_lm"):
        ta.ASRLoss(48000, loss_lm="nope", whisper_model=whispers[1])


def test_imports_without_transformers():
    code = ("import sys; sys.modules['transformers'] = None\n"
            "import deepfilternet_torch.train.asr_loss as m\n"
            "assert m.ASRLoss and 'transformers' not in [k for k, v in sys.modules.items() if v]\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
