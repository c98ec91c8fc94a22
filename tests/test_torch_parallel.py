"""The port's stream sharding (`deepfilternet_torch/parallel/`) on a mesh of
CPU devices: the mesh helpers, `ShardedStreamingRuntime` against the single
runtime and against JAX's `ShardedStreamingRuntime` on the 8-device CPU
mesh, stream counts that do not divide, `StreamServer(mesh=...)` and
`enhance(mesh=...)` against JAX's, within 1e-5."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepfilternet_tpu.enhance import enhance as j_enhance  # noqa: E402
from deepfilternet_tpu.parallel.mesh import data_parallel_mesh as j_mesh  # noqa: E402
from deepfilternet_tpu.parallel.streams import (  # noqa: E402
    ShardedStreamingRuntime as JShardedStreamingRuntime,
)
from deepfilternet_torch.enhance import enhance  # noqa: E402
from deepfilternet_torch.parallel import (  # noqa: E402
    Mesh,
    data_parallel_mesh,
    shard_batch,
    shard_params,
)
from deepfilternet_torch.parallel.streams import ShardedStreamingRuntime  # noqa: E402
from deepfilternet_torch.streaming import StreamingRuntime  # noqa: E402
from tests._torch_serving import (  # noqa: E402
    ATOL,
    HOP,
    jax_reference,
    load_models,
    port_config,
    stream,
    torch_server,
)

CPU = torch.device("cpu")
MESH = Mesh((CPU, CPU))


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    with port_config():
        yield


@pytest.fixture(scope="module")
def models():
    return load_models()


@pytest.fixture(scope="module")
def audio():
    """Seeded [8, 480*6]."""
    return (np.random.default_rng(3).standard_normal((8, HOP * 6)) * 0.1).astype(np.float32)


def test_mesh_devices():
    assert MESH.size == 2 and MESH.devices == (CPU, CPU)
    assert Mesh(("cpu",)).devices == (CPU,)
    with pytest.raises(ValueError):
        Mesh(())


def test_data_parallel_mesh_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_parallel_mesh()


def test_shard_batch_layout():
    batch = {"x": np.arange(64, dtype=np.float32).reshape(16, 4),
             "y": torch.arange(16)}
    shards = shard_batch(batch, Mesh((CPU,) * 8))
    assert len(shards) == 8
    assert shards[0]["x"].shape == (2, 4) and shards[0]["y"].tolist() == [0, 1]
    np.testing.assert_array_equal(torch.cat([s["x"] for s in shards]).numpy(), batch["x"])
    with pytest.raises(ValueError, match="divide"):
        shard_batch({"x": np.zeros((3, 4))}, MESH)


def test_shard_params_copies_per_device():
    params = {"a": {"w": torch.ones(3)}, "b": [torch.zeros(2)]}
    copies = shard_params(params, MESH)
    assert len(copies) == 2
    assert all(torch.equal(c["a"]["w"], params["a"]["w"]) for c in copies)


@pytest.mark.parametrize("call", ["process", "process_frame"])
def test_sharded_runtime_matches_single_and_jax(models, audio, call):
    """8 streams over 2 CPU devices: the same output as the single runtime,
    and as JAX's sharded runtime on its 8-device mesh; carry 4 streams a
    device."""
    jm, jd, tm, td = models
    srt = ShardedStreamingRuntime(tm, td, MESH)
    rt = StreamingRuntime(tm, td)
    carries = srt.init(8)
    assert [c.analysis_mem.shape[0] for c in carries] == [4, 4]
    if call == "process":
        _, got = srt.process(carries, audio)
    else:
        outs = []
        for k in range(audio.shape[1] // HOP):
            carries, o = srt.process_frame(carries, audio[:, k * HOP: (k + 1) * HOP])
            outs.append(o)
        got = torch.cat(outs, dim=1)
    _, single = rt.process(rt.init(8), audio)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0, atol=ATOL)
    jrt = JShardedStreamingRuntime(jm, jd, j_mesh())
    _, ref = jrt.process(jrt.init(8), jnp.asarray(audio))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("what", ["init", "process"])
def test_requires_divisible_streams(models, audio, what):
    srt = ShardedStreamingRuntime(models[2], models[3], MESH)
    with pytest.raises(ValueError, match="divide"):
        if what == "init":
            srt.init(3)
        else:
            srt.process(srt.init(8), audio[:3])


def test_server_over_mesh_matches_jax(models, audio):
    """StreamServer(mesh=...) splits its slots over both devices; 4 clients
    at once (slots on both shards) each match JAX's runtime."""
    import threading

    jm, jd, tm, td = models
    outs = [None] * 4
    with torch_server(tm, td, max_streams=4, mesh=MESH, batch_window_ms=50.0) as srv:
        assert srv.k1_in_graph == [0, 0]  # CPU shards: no graph

        def run(i):
            outs[i] = stream(srv.port, audio[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert srv.frames_processed == 4 * 6
    np.testing.assert_allclose(np.stack(outs), jax_reference(jm, jd, audio[:4]),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("atten_lim_db", [None, 12.0])
def test_enhance_mesh_matches_jax(models, audio, atten_lim_db):
    """enhance(backend="scan", mesh=...) against JAX's with its 8-device mesh,
    with and without the time-domain attenuation-limit mixback."""
    jm, jd, tm, td = models
    got = enhance(tm, td, audio, backend="scan", mesh=MESH, atten_lim_db=atten_lim_db)
    ref = j_enhance(jm, jd, audio, backend="scan", mesh=j_mesh(), atten_lim_db=atten_lim_db)
    assert got.shape == audio.shape
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    assert ("scan_runtime", MESH) in tm._cache
    with pytest.raises(ValueError, match="divide"):
        enhance(tm, td, audio[:3], backend="scan", mesh=MESH)
