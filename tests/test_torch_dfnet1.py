"""DeepFilterNet (v1) in the port against the JAX package, on the CPU.

  * random-init models at narrow widths (8 conv channels, GRUs of 64), the
    JAX parameters carried across: both `conv_dec_mode`s, grouped heads at 1
    and 4 groups (shuffle on and off), encoder convs of time kernel 1 (every
    conv context buffer zero frames), widths where convkxf's group rule and
    the gcd rule disagree, the mask post-filter. `forward` at 1e-4;
    `streaming_cell` over 9 frames and `forward_chunk` in two chunks at 1e-4
    against JAX (outputs and carry), the chunks against the cell at 2e-5, the
    cell against `forward` at 2e-4. In "upsample" mode JAX's DFN1 gives the
    decoder convs the stride instead of a frequency repeat and fails on its
    own skip sums; the comparison runs JAX's layers on the config the
    reference means (stride 1 after a repeat of 2), which the port builds;
  * the bundled `pretrained/dfn1_fixture_demo` at full width: `enhance()`
    offline and scan, `StreamingRuntime` (against JAX's with
    `use_pallas=True`) and `ChunkedStreamingRuntime` at 1e-4, mask-only
    against JAX's `init_df(mask_only=True)`, the CLI within one int16 step;
  * the runtimes this family is not taken by (bfloat16, the whole cell)
    raise NotImplementedError.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_families import (  # noqa: E402
    E2E,
    REPO,
    SMALL,
    audio,
    build,
    check_cell_and_chunk,
    check_fixture_entry_points,
    check_forward,
    close,
    load_fixture,
    rand_inputs,
)
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.enhance import enhance as j_enhance  # noqa: E402
from deepfilternet_tpu.enhance import main as j_main  # noqa: E402
from deepfilternet_tpu.models import dfnet1 as j_dfnet1  # noqa: E402
from deepfilternet_tpu.nn.layers import _conv_groups as j_conv_groups  # noqa: E402
from deepfilternet_tpu.streaming import StreamingRuntime as JRuntime  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import enhance, main  # noqa: E402
from deepfilternet_torch.models import dfnet1 as t_dfnet1  # noqa: E402
from deepfilternet_torch.streaming import ChunkedStreamingRuntime, StreamingRuntime  # noqa: E402
from deepfilternet_torch.streaming_whole_cell import WholeCellStreamingRuntime  # noqa: E402
from deepfilternet_torch.utils import load_audio, save_audio  # noqa: E402

MODEL_DIR = os.path.join(REPO, "pretrained", "dfn1_fixture_demo")
D = "deepfilternet"


def _keys(**extra):
    keys = dict(SMALL)
    keys.update({(k, "DF" if k == "DF_ORDER" else D): v for k, v in extra.items()})
    return keys


VARIANTS = {
    "transposed": _keys(),
    "upsample": _keys(CONV_DEC_MODE="upsample"),
    "groups_4": _keys(GRU_GROUPS="4", LINEAR_GROUPS="4", DF_NUM_LAYERS="2"),
    "groups_4_no_shuffle": _keys(GRU_GROUPS="4", LINEAR_GROUPS="4", GROUP_SHUFFLE="false"),
    "k_enc_1": _keys(CONV_K_ENC="1"),
    # df_convp 12 -> 8 channels, complex: convkxf gives 1 group, gcd (halved) 2
    "convkxf_groups_not_gcd": _keys(CONV_CH="12", DF_ORDER="4"),
    "mask_pf": _keys(MASK_PF="true", EMB_NUM_LAYERS="2"),
}


def _jax_upsample_as_meant(cfg):
    """JAX's DFN1 config with its "upsample" decoder convs as the reference
    means them: a frequency repeat of 2, then stride 1."""
    layers = dict(cfg["layers"])
    for name in ("convt2", "convt1"):
        if not layers[name]["transposed"] and layers[name]["fstride"] > 1:
            layers[name] = dict(layers[name], fstride=1, fupsample=layers[name]["fstride"])
    return dict(cfg, layers=layers)


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


def _model(keys):
    return build(j_dfnet1.init_dfnet1, t_dfnet1.init_dfnet1, keys, _jax_upsample_as_meant)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    model = _model(VARIANTS[variant])
    got = check_forward(j_dfnet1, t_dfnet1, model, rand_inputs(1, 2, 8, model[2]))
    assert np.isfinite(got[0].numpy()).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cell_and_chunk_match_jax(variant):
    model = _model(VARIANTS[variant])
    check_cell_and_chunk(j_dfnet1, t_dfnet1, model, rand_inputs(2, 2, 9, model[2]))


def test_group_rules():
    """convkxf's rule against the gcd rule, where they agree and where not,
    and the config the widths above give."""
    assert t_dfnet1._convkxf_groups(16, 16, True) == j_dfnet1._convkxf_groups(16, 16, True) == 16
    for args in ((12, 8, True, True), (16, 10, True, True), (2, 16, True), (16, 1, True),
                 (16, 16, False)):
        assert t_dfnet1._convkxf_groups(*args) == j_dfnet1._convkxf_groups(*args)
    assert t_dfnet1._convkxf_groups(12, 8, True, True) == 1
    assert j_conv_groups(12, 8, (1, 1), True) // 2 == 2
    cfg = _model(VARIANTS["convkxf_groups_not_gcd"])[5]
    assert cfg["layers"]["df_convp"]["groups"] == 1


def test_upsample_mode_repeats_then_convolves():
    _, _, _, tp, _, tcfg = _model(VARIANTS["upsample"])
    for name in ("convt2", "convt1"):
        lc = tcfg["layers"][name]
        assert not lc["transposed"] and (lc["fstride"], lc["fupsample"]) == (1, 2)
        assert "pw" in tp[name]  # convkxf's pointwise conv after the grouped one


# -- the bundled checkpoint at full width ------------------------------------------


@pytest.fixture(scope="module")
def fixture():
    return load_fixture(MODEL_DIR)


def test_fixture_loads(fixture):
    jm, _, tm, _ = fixture
    assert tm.module is t_dfnet1 and tm.epoch == jm.epoch == 46252
    assert tm.cfg["layers"]["convt2"]["transposed"] and tm.cfg["k_enc"] == 2


def test_fixture_entry_points_match_jax(fixture):
    check_fixture_entry_points(fixture, audio(2, 30, seed=31))


def test_fixture_mask_only_matches_jax():
    """init_df(mask_only=True): the ERB-masked spectrum, offline and per
    frame, against JAX's."""
    jm, jd, tm, td = load_fixture(MODEL_DIR, mask_only=True)
    assert tm.cfg["run_df"] is False is jm.cfg["run_df"]
    x = audio(2, 24, seed=32)
    got = enhance(tm, td, x)
    close(got, j_enhance(jm, jd, x), E2E, "offline mask-only")
    rt, jrt = StreamingRuntime(tm, td), JRuntime(jm, jd, use_pallas=True)
    _, ref = jrt.process(jrt.init(2), jnp.asarray(x))
    _, out = rt.process(rt.init(2), x)
    close(out, ref, E2E, "per-frame mask-only")
    # mask-only differs from the full model
    full = enhance(load_fixture(MODEL_DIR)[2], td, x)
    assert np.abs(full - got).max() > 1e-3


def test_fixture_cli_matches_jax_cli(tmp_path):
    x = audio(1, 25, seed=33)
    src = str(tmp_path / "noisy.wav")
    save_audio(src, x, 48000)
    j_out, t_out = tmp_path / "jax", tmp_path / "torch"
    try:
        j_main([src, "-m", MODEL_DIR, "-o", str(j_out)])
        main([src, "-m", MODEL_DIR, "-o", str(t_out), "--device", "cpu"])
    finally:
        j_config.reset()
        t_config.reset()
    name = "noisy_DeepFilterNet_TPU.wav"
    ref, _ = load_audio(str(j_out / name))
    got, _ = load_audio(str(t_out / name))
    assert got.shape == ref.shape == x.shape
    assert np.abs(got - ref).max() * 32768 <= 1.0


def test_fixture_refused_by_bf16_and_whole_cell_runtimes(fixture):
    _, _, tm, td = fixture
    for cls in (StreamingRuntime, ChunkedStreamingRuntime):
        with pytest.raises(NotImplementedError, match="dfnet1"):
            cls(tm, td, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="DeepFilterNet3 only"):
        WholeCellStreamingRuntime(tm, td, matmul_dtype=torch.float32, backend="plain")
