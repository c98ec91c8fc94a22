"""The fused analysis frontend (TPU kernel K1, `ops/pallas_frontend.py`) in
the PyTorch port: its plain version against the JAX Pallas kernel (run in
interpret mode on the CPU), the wrapper's dispatch, and, on a GPU only, the
CUDA kernel against its plain version."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu.ops.pallas_frontend import (  # noqa: E402
    fused_analysis_frontend as j_frontend,
)
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.ops.fused_frontend import (  # noqa: E402
    fused_analysis_frontend,
    fused_analysis_frontend_plain,
)
from deepfilternet_torch.ops.norms import mean_norm_init, unit_norm_init  # noqa: E402

NAMES = ("new_mem", "spec_re", "spec_im", "feat_erb", "fc_re", "fc_im",
         "new_mean", "new_unit")

# (fft, hop, nb_erb, nb_df): the default; DFN3-ll; the test_configs counts;
# 75% overlap (D != H); D and H not multiples of 32 (244 and 236); D and H
# not multiples of 4 (242 and 238: the kernel's 4-byte build)
SHAPES = [(960, 480, 32, 96), (480, 240, 32, 48), (960, 480, 24, 64), (960, 240, 32, 96),
          (480, 236, 32, 48), (480, 238, 32, 48)]
SHAPE_IDS = ["-".join(map(str, sh)) for sh in SHAPES]


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    """Reset the port's global config; run torch on one CPU thread (the
    per-frame ops are tiny, and the suite runs several workers at once)."""
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(rng, s, shape=SHAPES[0]):
    """A seeded mid-stream state: memory, ERB means around their init, unit
    norms in their init range."""
    fft, hop, nb_erb, nb_df = shape
    mem = (rng.standard_normal((s, fft - hop)) * 0.1).astype(np.float32)
    mean = (mean_norm_init(nb_erb) + rng.standard_normal((s, nb_erb)) * 5).astype(np.float32)
    unit = rng.uniform(1e-4, 1e-3, (s, nb_df)).astype(np.float32)
    return mem, mean, unit


def _geometry(shape):
    fft, hop, nb_erb, nb_df = shape
    return dict(fft_size=fft, hop_size=hop, nb_erb=nb_erb, nb_df=nb_df)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_pallas_kernel_over_chained_frames(shape):
    """S=8, 5 frames, each fed the previous frame's state; 1e-5 on all 8
    outputs. The new mean state sits near -75 dB, where 1e-5 is about one
    float32 ulp: the two sides round the EMA at different points."""
    rng = np.random.default_rng(21)
    mem, mean, unit = _state(rng, 8, shape)
    kw = _geometry(shape)
    js = [jnp.asarray(x) for x in (mem, mean, unit)]
    ts = [torch.from_numpy(x) for x in (mem, mean, unit)]
    for _ in range(5):
        frame = (rng.standard_normal((8, kw["hop_size"])) * 0.1).astype(np.float32)
        jo = j_frontend(js[0], jnp.asarray(frame), js[1], js[2], alpha=0.99, **kw)
        to = fused_analysis_frontend_plain(ts[0], torch.from_numpy(frame), ts[1], ts[2],
                                           alpha=0.99, **kw)
        for name, a, b in zip(NAMES, jo, to):
            assert b.shape == a.shape and b.dtype == torch.float32, name
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5,
                                       err_msg=name)
        js = [jo[0], jo[6], jo[7]]
        ts = [to[0], to[6], to[7]]


def test_plain_defaults_match_from_init_state():
    """From the runtime's initial state (zero memory, linspace norms)."""
    rng = np.random.default_rng(22)
    s = 3
    mem = np.zeros((s, 480), np.float32)
    mean = np.tile(mean_norm_init(32), (s, 1))
    unit = np.tile(unit_norm_init(96), (s, 1))
    frame = (rng.standard_normal((s, 480)) * 0.1).astype(np.float32)
    jo = j_frontend(jnp.asarray(mem), jnp.asarray(frame), jnp.asarray(mean),
                    jnp.asarray(unit), tile=s)
    to = fused_analysis_frontend_plain(*(torch.from_numpy(x) for x in (mem, frame, mean, unit)))
    for name, a, b in zip(NAMES, jo, to):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5, err_msg=name)


def test_wrapper_runs_plain_on_cpu_without_launching():
    rng = np.random.default_rng(23)
    mem, mean, unit = (torch.from_numpy(x) for x in _state(rng, 5))
    frame = torch.from_numpy((rng.standard_normal((5, 480)) * 0.1).astype(np.float32))
    before = fused_analysis_frontend.launches
    got = fused_analysis_frontend(mem, frame, mean, unit)
    ref = fused_analysis_frontend_plain(mem, frame, mean, unit)
    assert fused_analysis_frontend.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "shape", "unit_shape", "fft_below_hop",
                                 "nb_df_beyond_bins"])
def test_wrapper_rejects_bad_inputs(bad):
    """Bad tensors, and the geometries the TPU kernel cannot take either
    (fft < hop, more DF bins than bins), raise before any launch."""
    s = 4
    mem, frame = torch.zeros(s, 480), torch.zeros(s, 480)
    mean, unit = torch.zeros(s, 32), torch.ones(s, 96)
    kw = {}
    if bad == "dtype":
        frame = frame.double()
    elif bad == "shape":
        frame = torch.zeros(s, 479)
    elif bad == "unit_shape":
        unit = torch.ones(s, 128)
    elif bad == "fft_below_hop":
        kw = dict(fft_size=240, hop_size=480)
    else:
        unit = torch.ones(s, 482)
        kw = dict(nb_df=482)
    with pytest.raises((TypeError, ValueError)):
        fused_analysis_frontend(mem, frame, mean, unit, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("s", [1, 37, 256])
def test_cuda_kernel_matches_plain(cuda_device, s, shape):
    """The CUDA kernel against its plain version on the card, with TF32 off;
    1e-5 relative to each output's largest value (another summation order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(24)
    kw = _geometry(shape)
    mem, mean, unit = (torch.from_numpy(x).to(cuda_device) for x in _state(rng, s, shape))
    for _ in range(3):
        frame = torch.from_numpy(
            (rng.standard_normal((s, kw["hop_size"])) * 0.1).astype(np.float32)).to(cuda_device)
        before = fused_analysis_frontend.launches
        got = fused_analysis_frontend(mem, frame, mean, unit, **kw)
        assert fused_analysis_frontend.launches == before + 1
        ref = fused_analysis_frontend_plain(mem, frame, mean, unit, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(NAMES, got, ref):
            tol = 1e-5 * float(b.abs().max())
            assert float((a - b).abs().max()) <= tol, name
        mem, mean, unit = (ref[i].contiguous() for i in (0, 6, 7))


def _unaligned(t):
    """`t` copied into a contiguous tensor whose first element lies 4 bytes
    past a 16-byte boundary (the wrapper takes any contiguous tensor)."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    base = (-(buf.data_ptr() // 4) % 4 + 1) % 4
    out = buf[base: base + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("which", ["mem", "frame"])
def test_cuda_kernel_takes_unaligned_rows(cuda_device, which, shape):
    """mem or frame starting 4 bytes off a 16-byte boundary (the kernel's
    4-byte build at every geometry): the kernel against its plain version on
    the card, 1e-5 relative to each output's largest value."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(25)
    s, kw = 37, _geometry(shape)
    mem, mean, unit = (torch.from_numpy(x).to(cuda_device) for x in _state(rng, s, shape))
    frame = torch.from_numpy(
        (rng.standard_normal((s, kw["hop_size"])) * 0.1).astype(np.float32)).to(cuda_device)
    if which == "mem":
        mem = _unaligned(mem)
    else:
        frame = _unaligned(frame)
    before = fused_analysis_frontend.launches
    got = fused_analysis_frontend(mem, frame, mean, unit, **kw)
    assert fused_analysis_frontend.launches == before + 1
    ref = fused_analysis_frontend_plain(mem, frame, mean, unit, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, got, ref):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name
