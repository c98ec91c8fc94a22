"""The port's terminal demo client end to end (`tests/test_demo_client.py`'s
case): wav -> the port's server -> enhanced wav, held against JAX's
`StreamingRuntime.process` of the same audio; and the port's client against
JAX's server, which speaks the same protocol."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepfilternet_tpu.serve import StreamServer as JStreamServer  # noqa: E402
from deepfilternet_torch.scripts.demo_client import main as demo_main  # noqa: E402
from deepfilternet_torch.utils.audio_io import load_audio, save_audio  # noqa: E402
from tests._torch_serving import (  # noqa: E402
    HOP,
    jax_reference,
    load_models,
    port_config,
    torch_server,
)


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    with port_config():
        yield


@pytest.fixture(scope="module")
def models():
    return load_models()


@pytest.mark.parametrize("server_kind", ["port", "jax"])
def test_demo_client_end_to_end(models, rng, tmp_path, capsys, server_kind):
    jm, jd, tm, td = models
    audio = (rng.standard_normal((1, HOP * 6)) * 0.1).astype(np.float32)
    in_wav, out_wav = os.path.join(tmp_path, "in.wav"), os.path.join(tmp_path, "out.wav")
    save_audio(in_wav, audio, 48000, dtype="float32")
    if server_kind == "port":
        with torch_server(tm, td) as srv:
            demo_main([in_wav, "--port", str(srv.port), "--no-realtime", "--out", out_wav])
    else:
        jsrv = JStreamServer(jm, jd, port=0)
        jsrv.start()
        try:
            demo_main([in_wav, "--port", str(jsrv._sock.getsockname()[1]), "--no-realtime",
                       "--out", out_wav])
        finally:
            jsrv.stop()
    got, sr = load_audio(out_wav)
    assert sr == 48000
    loaded, _ = load_audio(in_wav)
    # 1e-4 as the JAX test: the wav is written as float32 and read back
    np.testing.assert_allclose(np.asarray(got)[0], jax_reference(jm, jd, np.asarray(loaded))[0],
                               rtol=0, atol=1e-4)
    assert "rtf=" in capsys.readouterr().out
