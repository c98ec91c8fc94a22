"""DeepFilterNet2 in the port against the JAX package, on the CPU.

  * random-init models at narrow widths (8 conv channels, GRUs of 64), the
    JAX parameters carried across: both `gru_type`s (grouped at 1 and 4
    groups), both `df_output_layer`s, the DF ops `real_unfold` (alpha blend),
    `complex_strided` and `df`, a DF pathway kernel of 5 frames, the mask
    post-filter. `forward` at 1e-4; `streaming_cell` over 9 frames and
    `forward_chunk` in two chunks at 1e-4 against JAX (outputs and carry),
    the chunks against the cell at 2e-5, the cell against `forward` at 2e-4;
    `df_n_iter = 2` offline (streaming refuses it);
  * the bundled `pretrained/dfn2_fixture_demo` at full width: `enhance()`
    offline and scan, `StreamingRuntime` (against JAX's with K1's
    counterpart, `use_pallas=True`) and `ChunkedStreamingRuntime` at 1e-4;
    the CLI within one int16 step of JAX's; a 2-slot `StreamServer` against
    `StreamingRuntime.process` at 1e-5;
  * the runtimes this family is not taken by (float16, the whole cell)
    raise NotImplementedError.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from _torch_families import (  # noqa: E402
    REPO,
    SMALL,
    audio,
    build,
    check_cell_and_chunk,
    check_fixture_entry_points,
    check_forward,
    load_fixture,
    rand_inputs,
)
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.enhance import main as j_main  # noqa: E402
from deepfilternet_tpu.models import dfnet2 as j_dfnet2  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import main  # noqa: E402
from deepfilternet_torch.models import dfnet2 as t_dfnet2  # noqa: E402
from deepfilternet_torch.streaming import ChunkedStreamingRuntime, StreamingRuntime  # noqa: E402
from deepfilternet_torch.streaming_whole_cell import WholeCellStreamingRuntime  # noqa: E402
from deepfilternet_torch.utils import load_audio, save_audio  # noqa: E402

MODEL_DIR = os.path.join(REPO, "pretrained", "dfn2_fixture_demo")
D = "deepfilternet"


def _keys(gru_type, df_out, dfop, **extra):
    keys = dict(SMALL)
    keys.update({("GRU_TYPE", D): gru_type, ("DF_OUTPUT_LAYER", D): df_out,
                 ("DFOP_METHOD", D): dfop, ("DF_N_ITER", D): "1"})
    keys.update({(k, D): v for k, v in extra.items()})
    return keys


VARIANTS = {
    # the released form (the fixture's)
    "squeeze_groupedlinear_complex_strided": _keys("squeeze", "groupedlinear", "complex_strided"),
    # the reference's defaults
    "grouped_linear_real_unfold": _keys("grouped", "linear", "real_unfold"),
    "grouped_4_groups_real_unfold": _keys("grouped", "groupedlinear", "real_unfold",
                                          GRU_GROUPS="4", LINEAR_GROUPS="4"),
    "grouped_4_groups_no_shuffle": _keys("grouped", "linear", "df", GRU_GROUPS="4",
                                         LINEAR_GROUPS="4", GROUP_SHUFFLE="false"),
    "squeeze_linear_df_skip": _keys("squeeze", "linear", "real_unfold", DF_GRU_SKIP="identity"),
    "squeeze_pathway_kt_5": _keys("squeeze", "groupedlinear", "complex_strided",
                                  DF_PATHWAY_KERNEL_SIZE_T="5"),
    "mask_pf_enc_concat": _keys("squeeze", "groupedlinear", "complex_strided", MASK_PF="true",
                                ENC_CONCAT="true"),
}


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
    return build(j_dfnet2.init_dfnet2, t_dfnet2.init_dfnet2, keys)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    model = _model(VARIANTS[variant])
    got = check_forward(j_dfnet2, t_dfnet2, model, rand_inputs(1, 2, 8, model[2]))
    assert np.isfinite(got[0].numpy()).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cell_and_chunk_match_jax(variant):
    model = _model(VARIANTS[variant])
    check_cell_and_chunk(j_dfnet2, t_dfnet2, model, rand_inputs(2, 2, 9, model[2]))


def test_df_n_iter_2_offline():
    """Two DF iterations run offline; the streaming forms refuse them, as
    JAX's assert."""
    keys = dict(VARIANTS["grouped_linear_real_unfold"])
    keys[("DF_N_ITER", D)] = "2"
    model = _model(keys)
    inputs = rand_inputs(3, 2, 6, model[2])
    check_forward(j_dfnet2, t_dfnet2, model, inputs)
    _, _, _, tp, ts, tcfg = model
    x = [torch.from_numpy(a) for a in inputs]
    with pytest.raises(NotImplementedError, match="df_n_iter"):
        t_dfnet2.streaming_cell(tp, ts, tcfg, t_dfnet2.streaming_init(2, tcfg),
                                *(a[:, 0] for a in x))
    with pytest.raises(NotImplementedError, match="df_n_iter"):
        t_dfnet2.forward_chunk(tp, ts, tcfg, t_dfnet2.streaming_init(2, tcfg), *x)


def test_carry_layout_has_one_stream_axis():
    """The server finds each carry leaf's stream axis by diffing two carries;
    the zero-frame DF pathway buffer (kernel of one frame) and the grouped
    [L*G, B, H/G] hiddens each have exactly one."""
    from deepfilternet_torch.serve import _stream_axes

    for variant in ("squeeze_groupedlinear_complex_strided", "grouped_4_groups_real_unfold"):
        cfg = _model(VARIANTS[variant])[5]

        class Rt:
            def init(self, n):
                return t_dfnet2.streaming_init(n, cfg)

        axes = _stream_axes(Rt())
        carry = Rt().init(3)
        assert carry.c0_buf.shape[2] == 0
        assert axes == [0, 0, 0, 1, 1, 1, 0, 0]


# -- the bundled checkpoint at full width ------------------------------------------


@pytest.fixture(scope="module")
def fixture():
    return load_fixture(MODEL_DIR)


def test_fixture_loads_the_released_form(fixture):
    jm, _, tm, _ = fixture
    assert tm.module is t_dfnet2 and tm.epoch == jm.epoch == 51914
    assert (tm.cfg["grouped"], tm.cfg["df_output_layer"], tm.cfg["dfop_method"],
            tm.cfg["df_n_iter"]) == (False, "groupedlinear", "complex_strided", 1)
    assert tm.cfg["conv_ch"] == 16 and tm.cfg["emb_hidden_dim"] == 256


def test_fixture_entry_points_match_jax(fixture):
    check_fixture_entry_points(fixture, audio(2, 30, seed=21))


def test_fixture_cli_matches_jax_cli(tmp_path):
    x = audio(1, 25, seed=22)
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


def test_fixture_server_matches_runtime(fixture):
    """Two clients of a 2-slot server, each equal to its stream through
    StreamingRuntime.process to 1e-5 (the JAX server tests' bound)."""
    from _torch_serving import ATOL, stream, torch_server

    _, _, tm, td = fixture
    x = audio(2, 12, seed=23)
    rt = StreamingRuntime(tm, td)
    _, ref = rt.process(rt.init(2), x)
    with torch_server(tm, td, max_streams=2) as srv:
        got = [stream(srv.port, x[i]) for i in range(2)]
    for g, r in zip(got, ref.numpy()):
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)


def test_fixture_refused_by_bf16_and_whole_cell_runtimes(fixture):
    _, _, tm, td = fixture
    # bfloat16 is taken since the family's cell is held to JAX's at it
    # (tests/test_torch_families_bf16.py); any other reduced type is not
    for cls in (StreamingRuntime, ChunkedStreamingRuntime):
        assert cls(tm, td, dtype=torch.bfloat16).dtype == torch.bfloat16
        with pytest.raises(NotImplementedError, match="dfnet2"):
            cls(tm, td, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="DeepFilterNet3 only"):
        WholeCellStreamingRuntime(tm, td, matmul_dtype=torch.float32, backend="plain")
