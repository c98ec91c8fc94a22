"""Checkpoint loading, configuration and entry points of the PyTorch port."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepfilternet_tpu import config as j_config_mod  # noqa: E402
from deepfilternet_tpu.checkpoint import read_cp as j_read_cp  # noqa: E402
from deepfilternet_tpu.enhance import DfState as JDfState  # noqa: E402
from deepfilternet_tpu.models import dfnet3 as j_dfnet3  # noqa: E402
from deepfilternet_torch import config as t_config_mod  # noqa: E402
from deepfilternet_torch.checkpoint import params_from_numpy, read_cp  # noqa: E402
from deepfilternet_torch.enhance import DfState, init_df  # noqa: E402
from deepfilternet_torch.models import dfnet3 as t_dfnet3  # noqa: E402
from deepfilternet_torch.models import init_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = ["dfn1_fixture_demo", "dfn2_fixture_demo", "dfn3_fixture_demo"]


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    """Reset the port's global config; run torch on one CPU thread (the
    per-frame ops are tiny, and the suite runs several workers at once)."""
    t_config_mod.config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", FIXTURES)
def test_read_cp_matches_jax(name):
    """Same keys, shapes and values as the JAX reader, without optax."""
    ckpt = os.path.join(REPO, "pretrained", name, "checkpoints")
    got = read_cp(ckpt, which="best")
    ref = j_read_cp(ckpt, which="best")
    assert "opt_state" not in got and "opt_state" in ref
    assert got["epoch"] == ref["epoch"]
    for key in ("params", "state"):
        g_leaves, g_def = jax.tree.flatten(got[key])
        r_leaves, r_def = jax.tree.flatten(ref[key])
        assert g_def == r_def
        for a, b in zip(g_leaves, r_leaves):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, np.asarray(b))


def test_read_cp_epoch_selection(tmp_path):
    assert read_cp(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        read_cp(os.path.join(REPO, "pretrained", "dfn3_fixture_demo", "checkpoints"), which=7)


def test_params_from_numpy_tree():
    params = {"a": {"w": np.ones((2, 3), np.float32)},
              "l": [{"b": np.zeros(4, np.float32)}]}
    tp, ts = params_from_numpy(params, {"bn": {"mean": np.arange(3, dtype=np.float32)}}, "cpu")
    assert isinstance(tp["l"], list) and tp["a"]["w"].dtype == torch.float32
    assert tp["a"]["w"].shape == (2, 3) and torch.equal(ts["bn"]["mean"], torch.arange(3.0))
    tp["a"]["w"] += 1  # the tensors own their memory
    assert params["a"]["w"][0, 0] == 1.0


def test_config_defaults_match_jax():
    """config.ini of the demo model is empty: the defaults alone define it."""
    j_config_mod.config.reset()
    t_config_mod.config.reset()
    assert vars(t_dfnet3.ModelParams3()) == vars(j_dfnet3.ModelParams3())
    assert t_config_mod.config.obj.tostr() == j_config_mod.config.obj.tostr()
    assert DfState() == DfState(**vars(JDfState()))
    assert DfState().min_nb_erb_freqs == 1  # init_df passes the config's 2


def test_config_env_override_and_ini(tmp_path, monkeypatch):
    ini = tmp_path / "config.ini"
    ini.write_text("[deepfilternet]\nconv_ch = 8\n[df]\nnb_df = 64\n")
    t_config_mod.config.reset()
    t_config_mod.config.load(str(ini))
    monkeypatch.setenv("EMB_HIDDEN_DIM", "128")
    p = t_dfnet3.ModelParams3()
    assert (p.conv_ch, p.nb_df, p.emb_hidden_dim) == (8, 64, 128)
    t_config_mod.config.reset()


def test_other_model_families_not_ported():
    """Every family of the JAX registry is ported now: each name resolves to
    the port's module of the same role, with JAX's config keys; an unknown
    name still raises."""
    from deepfilternet_tpu.models import init_model as j_init_model

    for name, mod in (("deepfilternet2", "dfnet2"), ("deepfilternet", "dfnet1"),
                      ("deepfilternetmf", "dfnetmf")):
        _, _, cfg, module = init_model(name, device="cpu")
        _, _, j_cfg, j_module = j_init_model(name)
        assert module.__name__ == f"deepfilternet_torch.models.{mod}"
        assert j_module.__name__ == f"deepfilternet_tpu.models.{mod}"
        assert cfg.keys() == j_cfg.keys()
    with pytest.raises(ValueError):
        init_model("nonsense", device="cpu")


def test_init_df_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_df(os.path.join(REPO, "pretrained", "dfn3_fixture_demo"))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_df(os.path.join(REPO, "pretrained", "dfn3_fixture_demo"), device="cuda")


def test_init_df_cpu_loads_demo_checkpoint():
    model, df_state, suffix = init_df(os.path.join(REPO, "pretrained", "dfn3_fixture_demo"),
                                      device="cpu")
    assert suffix == "e234408" and model.device == torch.device("cpu")
    assert df_state.min_nb_erb_freqs == 2
    assert model.params["df_out"]["w"].shape == (1, 256, 960)


def test_port_imports_no_jax_at_run_time(tmp_path):
    """A fresh interpreter loads the demo model and runs 3 frames per frame
    (float32 and bfloat16), through the whole cell (its bfloat16 default),
    the offline enhance, the chunked runtime, the CLI, a stream server (one
    round trip) and the sharded runtime; the DFN2 and DFN1 checkpoints per
    frame and offline, DeepFilterNet-MF offline, with the converters
    imported; then no jax, optax or deepfilternet_tpu module may be
    loaded."""
    code = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        import torch
        from deepfilternet_torch.enhance import enhance, init_df, main
        from deepfilternet_torch.streaming import ChunkedStreamingRuntime, StreamingRuntime
        from deepfilternet_torch.streaming_whole_cell import WholeCellStreamingRuntime
        from deepfilternet_torch.utils import save_audio
        from deepfilternet_torch.parallel import Mesh
        from deepfilternet_torch.parallel.streams import ShardedStreamingRuntime
        from deepfilternet_torch.serve import StreamClient, StreamServer
        from deepfilternet_torch.serve_ws import WsBridge
        from deepfilternet_torch.scripts.demo_client import main as demo_main
        model, df_state, _ = init_df("pretrained/dfn3_fixture_demo", device="cpu")
        rt = StreamingRuntime(model, df_state)
        audio = np.random.default_rng(0).standard_normal((2, 480 * 3)).astype(np.float32)
        _, out = rt.process(rt.init(2), audio)
        assert out.shape == (2, 1440)
        brt = StreamingRuntime(model, df_state, dtype=torch.bfloat16, out_dtype=torch.bfloat16)
        assert brt.process(brt.init(2), audio)[1].dtype == torch.bfloat16
        wrt = WholeCellStreamingRuntime(model, df_state)
        assert wrt.weights["dft"].dtype == torch.bfloat16
        assert wrt.process(wrt.init(2), audio)[1].shape == (2, 1440)
        assert enhance(model, df_state, audio, backend="offline").shape == (2, 1440)
        crt = ChunkedStreamingRuntime(model, df_state, chunk_frames=2)
        assert crt.process(crt.init(2), audio)[1].shape == (2, 1440)
        save_audio({str(tmp_path / "in.wav")!r}, audio[:1] * 0.1, 48000)
        main([{str(tmp_path / "in.wav")!r}, "-o", {str(tmp_path)!r}, "--device", "cpu"])
        assert os.path.isfile({str(tmp_path / "in_DeepFilterNet_TPU.wav")!r})
        srv = StreamServer(model, df_state, port=0).start()
        client = StreamClient(port=srv.port)
        assert client.process_frame(audio[0, :960]).shape == (960,)
        client.close()
        srv.stop()
        srt = ShardedStreamingRuntime(model, df_state, Mesh(("cpu", "cpu")))
        assert srt.process(srt.init(2), audio)[1].shape == (2, 1440)
        from deepfilternet_torch.checkpoint import convert_dfn1_state_dict, load_torch_checkpoint
        for other in ("pretrained/dfn2_fixture_demo", "pretrained/dfn1_fixture_demo"):
            m, d, _ = init_df(other, device="cpu")
            ort = StreamingRuntime(m, d)
            assert ort.process(ort.init(2), audio)[1].shape == (2, 1440)
            assert enhance(m, d, audio).shape == (2, 1440)
        from deepfilternet_torch.config import config
        config.reset()  # a loaded model dir's keys (and the defaults read) stay set
        m, d, _ = init_df(model_name="deepfilternetmf", device="cpu")
        assert enhance(m, d, audio).shape == (2, 1440)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "optax", "deepfilternet_tpu"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
