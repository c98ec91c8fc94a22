"""The port's training losses against the JAX package's, on the CPU.

Same seeded inputs (with exact-zero bins and frames: silence and padding)
through `deepfilternet_tpu.train.loss` and `deepfilternet_torch.train.loss`,
float32 on both sides: every loss function and the `Loss` aggregator in
several configurations, the value within 1e-5 of its size (a sum of
parts: of the parts' magnitudes) and the gradient
of every differentiated input within 1e-4 of its largest magnitude;
`hann_stft`, `loss_istft` (against JAX's, and the scaled signal it must
reconstruct), `local_snr_target` and `safe_angle`'s clamped gradient at
1e-5.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.ops import Stft as JStft  # noqa: E402
from deepfilternet_tpu.ops import erb_fb_matrices, erb_widths  # noqa: E402
from deepfilternet_tpu.ops.lsnr import local_snr_target as j_lsnr_target  # noqa: E402
from deepfilternet_tpu.ops.stft import vorbis_window  # noqa: E402
from deepfilternet_tpu.train import loss as jl  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.ops import stft as t_stft  # noqa: E402
from deepfilternet_torch.ops.lsnr import local_snr_target as t_lsnr_target  # noqa: E402
from deepfilternet_torch.train import loss as tl  # noqa: E402

WIDTHS = erb_widths(48000, 960, 32, 2)
VALUE_REL, GRAD_REL = 1e-5, 1e-4
B, T, F, E = 2, 12, 481, 32


@pytest.fixture(scope="module", autouse=True)
def _fresh_configs():
    """Reset both packages' configs; run torch on one CPU thread (the suite
    runs several workers at once)."""
    j_config.reset()
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    j_config.reset()
    t_config.reset()


J = SimpleNamespace(mod=jl, c=lambda x: x[..., 0] + 1j * x[..., 1], fb=jnp.asarray)
P = SimpleNamespace(mod=tl, c=lambda x: torch.complex(x[..., 0], x[..., 1]),
                    fb=torch.from_numpy)


def _data(seed=0):
    """Spectra re/im [B, T, F, 2] with exact zeros: clean silent in frames
    0-1 and above bin 400, the noise zero in frame 2, the estimate zero in
    frames 4-5; a mask in [0, 1] [B, T, E] with exact zeros; lsnr and alpha
    [B, T, 1]; time signals [B, 4800] with a silent stretch."""
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((B, T, F, 2)) * 0.05).astype(np.float32)
    clean[:, :2] = 0
    clean[:, :, 400:] = 0
    noise = (rng.standard_normal((B, T, F, 2)) * 0.02).astype(np.float32)
    noise[:, 2] = 0
    enh = (clean + noise * 0.5).astype(np.float32)
    enh[:, 4:6] = 0
    mask = rng.uniform(0, 1, (B, T, E)).astype(np.float32)
    mask[:, 3] = 0
    td = rng.standard_normal((B, 4800)).astype(np.float32) * 0.1
    td[:, 1000:1500] = 0
    return dict(clean=clean, noisy=(clean + noise).astype(np.float32), enh=enh, mask=mask,
                lsnr=rng.uniform(-15, 35, (B, T, 1)).astype(np.float32),
                alpha=rng.uniform(0, 1, (B, T, 1)).astype(np.float32),
                clean_td=td, enh_td=(td * 0.8 + rng.standard_normal(td.shape) * 0.01
                                     ).astype(np.float32))


# loss -> (the input it differentiates, fn(framework, pred, data))
CASES = {
    "spectral_gamma": ("enh", lambda m, p, d: m.mod.spectral_loss(
        m.c(p), m.c(d["clean"]), gamma=0.6, factor_magnitude=100, factor_complex=100,
        factor_under=2.0)),
    "spectral_linear": ("enh", lambda m, p, d: m.mod.spectral_loss(
        m.c(p), m.c(d["clean"]), gamma=1.0, factor_magnitude=1, factor_complex=1)),
    "mrsl_gamma": ("enh_td", lambda m, p, d: m.mod.multi_res_spec_loss(
        p, d["clean_td"], (256, 512), gamma=0.3, factor=500, factor_complex=10)),
    "mrsl_linear": ("enh_td", lambda m, p, d: m.mod.multi_res_spec_loss(
        p, d["clean_td"], (512, 1024, 2048), factor=1)),
    **{f"mask_{kind}": ("mask", lambda m, p, d, kind=kind: m.mod.mask_loss(
        p, m.c(d["clean"]), m.c(d["noisy"]), m.fb(erb_fb_matrices(WIDTHS, True, False)),
        mask=kind)) for kind in ("iam", "irm", "wg")},
    "mask_max_bin": ("mask", lambda m, p, d: m.mod.mask_loss(
        p, m.c(d["clean"]), m.c(d["noisy"]), m.fb(erb_fb_matrices(WIDTHS, True, False)),
        gamma=0.3, gamma_pred=0.5, f_under=1.0,
        max_bin_mask=m.fb((np.arange(E) < 20).astype(np.float32)))),
    "sdr": ("enh_td", lambda m, p, d: m.mod.sdr_loss(p, d["clean_td"], factor=0.2)),
    "seg_sdr": ("enh_td", lambda m, p, d: m.mod.seg_sdr_loss(
        p, d["clean_td"], (480, 1000, 10000), factor=0.2, overlap=0.5)),
    "local_snr": ("lsnr", lambda m, p, d: m.mod.local_snr_loss(
        p, d["mask"][..., 0] * 50 - 15, factor=0.0005)),
    "df_alpha": ("alpha", lambda m, p, d: m.mod.df_alpha_loss(
        p, d["lsnr"][..., 0], factor=2.0)),
}


def _value_and_grad(fw, fn, pred, data):
    if fw is J:
        dj = {k: jnp.asarray(v) for k, v in data.items()}
        v, g = jax.value_and_grad(lambda p: fn(J, p, dj))(jnp.asarray(pred))
        return float(v), np.asarray(g)
    dt = {k: torch.from_numpy(v) for k, v in data.items()}
    p = torch.from_numpy(pred.copy()).requires_grad_(True)
    v = fn(P, p, dt)
    (g,) = torch.autograd.grad(v, p)
    return float(v.detach()), g.numpy()


def _close_rel(got, ref, rel, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.all(np.isfinite(got)), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_function(case):
    key, fn = CASES[case]
    data = _data()
    pred = data.pop(key)
    v_ref, g_ref = _value_and_grad(J, fn, pred, data)
    v, g = _value_and_grad(P, fn, pred, data)
    _close_rel(v, v_ref, VALUE_REL, "value")
    _close_rel(g, g_ref, GRAD_REL, "gradient")


# [section] key = value in both configs -> the parts the aggregator must give
AGGREGATES = {
    "demo_stack": ({("factor_magnitude", "SpectralLoss"): "100",
                    ("factor_complex", "SpectralLoss"): "100", ("gamma", "SpectralLoss"): "0.6",
                    ("factor", "MaskLoss"): "1", ("factor", "MultiResSpecLoss"): "500",
                    ("fft_sizes", "MultiResSpecLoss"): "256,512,1024"},
                   {"spectral", "mask", "mrsl", "lsnr"}),
    "exact_istft_sdr_alpha": ({("TD_LOSS_ISTFT", "train"): "exact",
                               ("factor", "SdrLoss"): "0.2", ("factor", "DfAlphaLoss"): "1",
                               ("factor", "MultiResSpecLoss"): "1",
                               ("factor_complex", "MultiResSpecLoss"): "1",
                               ("gamma", "MultiResSpecLoss"): "0.5",
                               ("factor_under", "SpectralLoss"): "2",
                               ("factor_magnitude", "SpectralLoss"): "1"},
                              {"spectral", "mrsl", "sdr", "lsnr", "df_alpha"}),
    "mask_spec_seg_sdr": ({("factor", "MaskLoss"): "1", ("mask", "MaskLoss"): "spec",
                           ("max_freq", "MaskLoss"): "12000", ("factor", "SdrLoss"): "0.1",
                           ("segmental_ws", "SdrLoss"): "960,4800",
                           ("factor", "LocalSnrLoss"): "0.01"},
                          {"mask", "sdr", "lsnr"}),
    "mask_wg": ({("factor", "MaskLoss"): "10", ("mask", "MaskLoss"): "wg",
                 ("max_freq", "MaskLoss"): "8000"}, {"mask", "lsnr"}),
}


def _aggregate(fw, loss_obj, data, preds):
    names = ("enh", "mask", "lsnr", "alpha")

    def fn(*ps):
        kw = dict(zip(names, ps))
        return loss_obj(fw.c(data["clean"]), fw.c(data["noisy"]), fw.c(kw["enh"]), kw["mask"],
                        kw["lsnr"], df_alpha=kw["alpha"])

    if fw is J:
        data = {k: jnp.asarray(v) for k, v in data.items()}
        (total, parts), grads = jax.value_and_grad(fn, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(p) for p in preds))
        return float(total), {k: float(v) for k, v in parts.items()}, [np.asarray(g) for g in grads]
    data = {k: torch.from_numpy(v) for k, v in data.items()}
    ps = [torch.from_numpy(p.copy()).requires_grad_(True) for p in preds]
    total, parts = fn(*ps)
    grads = torch.autograd.grad(total, ps, allow_unused=True)
    return (float(total.detach()), {k: float(v.detach()) for k, v in parts.items()},
            [np.zeros_like(p.detach().numpy()) if g is None else g.numpy()
             for p, g in zip(ps, grads)])


@pytest.mark.parametrize("name", sorted(AGGREGATES))
def test_loss_aggregator(name):
    keys, want = AGGREGATES[name]
    data = _data(1)
    preds = [data.pop(k) for k in ("enh", "mask", "lsnr", "alpha")]
    out = {}
    for fw, stft, cfg in ((J, JStft(48000, 960, 480), j_config),
                          (P, t_stft.Stft(48000, 960, 480), t_config)):
        cfg.reset()
        for (key, section), value in keys.items():
            cfg.set(key, value, section=section)
        out[fw.mod.__name__] = _aggregate(fw, fw.mod.Loss(stft, WIDTHS, 96, (-15, 35)), data,
                                          preds)
        cfg.reset()
    (tot, parts, grads), (tot_ref, parts_ref, grads_ref) = out[tl.__name__], out[jl.__name__]
    assert set(parts) == set(parts_ref) == want
    # the parts can cancel (SDR is negative): the total's rounding scales
    # with the magnitudes summed
    assert abs(tot - tot_ref) <= VALUE_REL * sum(abs(v) for v in parts_ref.values())
    for k in parts:
        _close_rel(parts[k], parts_ref[k], VALUE_REL, k)
    for what, g, r in zip(("enhanced", "mask", "lsnr", "alpha"), grads, grads_ref):
        if np.abs(r).max() == 0:
            np.testing.assert_array_equal(g, r, err_msg=what)
        else:
            _close_rel(g, r, GRAD_REL, what)


def test_asr_loss_is_refused():
    t_config.reset()
    t_config.set("factor", "1", section="ASRLoss")
    try:
        with pytest.raises(NotImplementedError, match="ASRLoss"):
            tl.Loss(t_stft.Stft(48000, 960, 480), WIDTHS, 96, (-15, 35))
    finally:
        t_config.reset()
    with pytest.raises(NotImplementedError, match="ASRLoss"):
        tl.Loss(t_stft.Stft(48000, 960, 480), WIDTHS, 96, (-15, 35), asr_model=object())


@pytest.mark.parametrize("n_fft", [256, 960])
def test_hann_stft(n_fft):
    x = np.random.default_rng(2).standard_normal((2, 3, 4000)).astype(np.float32)
    got = tl.hann_stft(torch.from_numpy(x), n_fft).numpy()
    ref = np.asarray(jl.hann_stft(jnp.asarray(x), n_fft))
    _close_rel(got, ref, VALUE_REL)


@pytest.mark.parametrize("fft, hop", [(960, 480), (512, 128)])
def test_loss_istft(fft, hop):
    """Against JAX's on random spectra; and on the port's forward-normalized
    STFT of x it gives sqrt(n_fft) * wnorm * x, but for the last hop (its
    second frame is the appended zero frame)."""
    spec = np.random.default_rng(3).standard_normal((2, 9, fft // 2 + 1, 2)).astype(np.float32)
    spec = (spec[..., 0] + 1j * spec[..., 1]).astype(np.complex64)
    win = vorbis_window(fft)
    got = tl.loss_istft(torch.from_numpy(spec), fft, hop, torch.from_numpy(win.copy())).numpy()
    ref = np.asarray(jl.loss_istft(jnp.asarray(spec), fft, hop, win))
    _close_rel(got, ref, VALUE_REL)
    if hop * 2 == fft:
        x = np.random.default_rng(4).standard_normal((2, hop * 12)).astype(np.float32)
        y = tl.loss_istft(t_stft.stft(torch.from_numpy(x), t_stft.Stft(48000, fft, hop)), fft,
                          hop, torch.from_numpy(win.copy())).numpy()
        c = math.sqrt(fft) * t_stft.wnorm(fft, hop)
        np.testing.assert_allclose(y[:, :-hop], c * x[:, :-hop], rtol=0, atol=1e-6)


@pytest.mark.parametrize("max_bin", [None, 200])
def test_local_snr_target(max_bin):
    d = _data(5)
    c, n = d["clean"], d["noisy"] - d["clean"]
    j = lambda a: jnp.asarray(a[..., 0] + 1j * a[..., 1])  # noqa: E731
    ref = j_lsnr_target(j(c), j(n), 48000, 960, 480, (-16, 36), max_bin=max_bin)
    got = t_lsnr_target(P.c(torch.from_numpy(c)), P.c(torch.from_numpy(n)), 48000, 960, 480,
                        (-16, 36), max_bin=max_bin)
    _close_rel(got.numpy(), np.asarray(ref), VALUE_REL)
    assert float(got.min()) == -16  # the silent frames clamp to the range


def test_safe_angle_clamped_gradient():
    rng = np.random.default_rng(6)
    z = (rng.standard_normal((4, 50)) + 1j * rng.standard_normal((4, 50))).astype(np.complex64)
    z[:, :5] = 0
    z[:, 5:8] = 1e-7  # |z|^2 below the clamp
    zt = torch.from_numpy(z).requires_grad_(True)
    ang = tl.safe_angle(zt)
    np.testing.assert_allclose(ang.detach().numpy(), np.angle(z), rtol=0, atol=1e-6)
    w = rng.standard_normal(z.shape).astype(np.float32)
    (g,) = torch.autograd.grad((ang * torch.from_numpy(w)).sum(), zt)
    # JAX differentiates the same function with respect to re and im
    g_re, g_im = jax.grad(lambda re, im: jnp.sum(jl.safe_angle(re + 1j * im) * w),
                          argnums=(0, 1))(jnp.asarray(z.real), jnp.asarray(z.imag))
    # torch's gradient of a real function of z is d/dre + i d/dim
    _close_rel(g.real.numpy(), np.asarray(g_re), VALUE_REL)
    _close_rel(g.imag.numpy(), np.asarray(g_im), VALUE_REL)
    assert np.all(g.numpy()[:, :5] == 0)
    # below the clamp the denominator is 1e-10: 1e-7 / 1e-10 = 1e3 times w
    np.testing.assert_allclose(g.imag.numpy()[:, 5:8], 1e-7 / 1e-10 * w[:, 5:8], rtol=1e-5)
