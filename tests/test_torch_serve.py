"""The port's stream server (`deepfilternet_torch/serve.py`) on the CPU, with
the demo checkpoint at full width: the cases of `tests/test_serve.py`, each
client's output held against JAX's `StreamingRuntime.process` of the same
audio at atol 1e-5 (the JAX server tests' bound), the wire protocol against
JAX's server and client in both directions, and, on a card, the captured
tick."""

import socket
import subprocess
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepfilternet_tpu.serve import MAGIC as J_MAGIC  # noqa: E402
from deepfilternet_tpu.serve import StreamClient as JStreamClient  # noqa: E402
from deepfilternet_tpu.serve import StreamServer as JStreamServer  # noqa: E402
from deepfilternet_torch.serve import MAGIC, StreamClient, StreamServer  # noqa: E402
from deepfilternet_torch.streaming import RuntimeParams  # noqa: E402
from tests._torch_serving import (  # noqa: E402
    ATOL,
    HOP,
    NATIVE,
    jax_reference,
    load_models,
    port_config,
    stream,
    torch_server,
)


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    with port_config():
        yield


@pytest.fixture(scope="module")
def models():
    return load_models()


@pytest.fixture(scope="module")
def server(models):
    with torch_server(models[2], models[3]) as srv:
        yield srv


def _audio(rng, *shape):
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


def test_magic_matches_jax():
    assert MAGIC == J_MAGIC == 0x44465331


class TestStreamServer:
    def test_round_trip_matches_jax(self, models, server, rng):
        jm, jd, _, _ = models
        audio = _audio(rng, 1, HOP * 6)
        got = stream(server.port, audio[0], hops_a_request=2)
        np.testing.assert_allclose(got, jax_reference(jm, jd, audio)[0], rtol=0, atol=ATOL)

    def test_rejects_partial_hop(self, server):
        client = StreamClient(port=server.port)
        out = client.process_frame(np.zeros(100, np.float32))
        assert out.size == 0
        client.sock.close()

    def test_concurrent_clients_are_isolated(self, server, rng):
        c1 = StreamClient(port=server.port)
        c2 = StreamClient(port=server.port)
        a1, a2 = _audio(rng, 2 * HOP), _audio(rng, 2 * HOP)
        o1a = c1.process_frame(a1)
        o2 = c2.process_frame(a2)
        o1b = c1.process_frame(a1)
        c1.close()
        c2.close()
        # the second call differs from the first (state advanced); c2 was not
        # affected by c1's state
        assert not np.allclose(o1a, o1b)
        assert o2.shape == o1a.shape


class TestDynamicBatching:
    def test_concurrent_clients_batch_into_one_dispatch(self, models, rng):
        """4 concurrent clients: their hops share ticks (dispatches < frames)
        and each stream equals its own run of JAX's runtime."""
        jm, jd, tm, td = models
        n_clients, n_frames = 4, 3
        audios = _audio(rng, n_clients, HOP * n_frames)
        outs = [None] * n_clients
        with torch_server(tm, td, max_streams=8, batch_window_ms=120.0) as srv:
            def run(i):
                outs[i] = stream(srv.port, audios[i])

            threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            assert srv.frames_processed == n_clients * n_frames
            # with a 120 ms coalescing window all 4 clients share each tick
            assert srv.dispatches <= n_frames + 1, (srv.dispatches, srv.frames_processed)
            assert srv.graph_captures == 0 and srv.graph_replays == 0  # the CPU ticks eagerly
        np.testing.assert_allclose(np.stack(outs), jax_reference(jm, jd, audios),
                                   rtol=0, atol=ATOL)

    def test_idle_slots_state_frozen(self, models, rng):
        """A client that pauses while another streams sees no state advance:
        its next frame matches an uninterrupted run."""
        jm, jd, tm, td = models
        a, b = _audio(rng, HOP * 4), _audio(rng, HOP * 6)
        with torch_server(tm, td, max_streams=4, batch_window_ms=0.0) as srv:
            c1 = StreamClient(port=srv.port)
            o1a = c1.process_frame(a[: HOP * 2])
            stream(srv.port, b)  # a second client streams alone; c1 is idle
            o1b = c1.process_frame(a[HOP * 2:])
            c1.close()
        got = np.concatenate([o1a, o1b])
        np.testing.assert_allclose(got, jax_reference(jm, jd, a[None])[0], rtol=0, atol=ATOL)

    def test_pool_exhaustion_rejected(self, models):
        with torch_server(models[2], models[3], max_streams=1, batch_window_ms=0.0) as srv:
            c1 = StreamClient(port=srv.port)
            assert c1.process_frame(np.zeros(HOP, np.float32)).size == HOP
            c2 = StreamClient(port=srv.port)
            assert c2.process_frame(np.zeros(HOP, np.float32)).size == 0  # no free slot
            c1.close()
            c2.sock.close()


def test_many_clients_stress(models, rng):
    """More client threads than cores, with a short thread switch interval:
    every hop is counted once and every stream still equals JAX's (a lost
    update of the pending map or the slot pool would break either)."""
    import sys

    jm, jd, tm, td = models
    n_clients, n_frames = 16, 4
    audios = _audio(rng, n_clients, HOP * n_frames)
    outs = [None] * n_clients
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with torch_server(tm, td, max_streams=n_clients) as srv:
            def run(i):
                outs[i] = stream(srv.port, audios[i])

            threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            assert srv.frames_processed == n_clients * n_frames
            assert srv.error is None
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_allclose(np.stack(outs), jax_reference(jm, jd, audios), rtol=0, atol=ATOL)


def test_stereo_clients_share_reduced_mask(models, rng):
    """Two connections carry a stereo pair as one channel group
    (reduce_mask="max"): the server's output equals JAX's runtime with the
    same params on the [2, T] pair, which differs from independent streams."""
    jm, jd, tm, td = models
    rp = dict(reduce_mask="max", n_channels=2)
    n_frames = 4
    audio = _audio(rng, 2, HOP * n_frames)
    outs = [None, None]
    barrier = threading.Barrier(2)
    with torch_server(tm, td, max_streams=2, runtime_params=RuntimeParams(**rp),
                      batch_window_ms=120.0) as srv:
        def run(ch):
            c = StreamClient(port=srv.port)
            got = []
            for k in range(n_frames):
                barrier.wait()  # keep both hops inside one tick window
                got.append(c.process_frame(audio[ch, k * HOP: (k + 1) * HOP]))
            c.close()
            outs[ch] = np.concatenate(got)

        # connect the left channel first, so channel -> slot order is fixed
        t0 = threading.Thread(target=run, args=(0,))
        t0.start()
        time.sleep(0.3)
        t1 = threading.Thread(target=run, args=(1,))
        t1.start()
        t0.join(180)
        t1.join(180)
        assert not (t0.is_alive() or t1.is_alive())
    got = np.stack(outs)
    np.testing.assert_allclose(got, jax_reference(jm, jd, audio, **rp), rtol=0, atol=ATOL)
    assert not np.allclose(got, jax_reference(jm, jd, audio), atol=ATOL)


def test_c_client_round_trip(server, rng, tmp_path):
    """The native C client (`native/df_client.c`), built here, streams two
    hops through the port's server and gets what the Python client gets."""
    exe, main_c = tmp_path / "df_c_test", tmp_path / "main.c"
    main_c.write_text(r'''
#include "df_client.h"
#include <stdio.h>
#include <stdlib.h>
int main(int argc, char **argv) {
    int port = atoi(argv[1]);
    DfClient *df = df_create("127.0.0.1", port);
    if (!df) { fprintf(stderr, "connect failed\n"); return 2; }
    size_t n = df_get_frame_length(df) * 2;
    float *in = calloc(n, 4), *out = calloc(n, 4);
    FILE *fi = fopen(argv[2], "rb");
    if (fread(in, 4, n, fi) != n) return 4;
    fclose(fi);
    if (df_process_frame(df, in, out, n) != 0) return 3;
    FILE *fo = fopen(argv[3], "wb");
    fwrite(out, 4, n, fo); fclose(fo);
    df_free(df);
    return 0;
}
''')
    subprocess.run(["gcc", "-O2", "-I", NATIVE, str(main_c), f"{NATIVE}/df_client.c",
                    "-o", str(exe)], check=True, capture_output=True)
    audio = _audio(rng, 2 * HOP)
    fin, fout = tmp_path / "in.f32", tmp_path / "out.f32"
    audio.tofile(fin)
    subprocess.run([str(exe), str(server.port), str(fin), str(fout)], check=True, timeout=120)
    got = np.fromfile(fout, np.float32)
    py = StreamClient(port=server.port)
    expected = py.process_frame(audio)
    py.close()
    assert got.size == 2 * HOP
    np.testing.assert_allclose(got, expected, atol=1e-6)


def test_client_times_out_on_dead_server():
    """A server that accepts but never replies makes process_frame raise
    TimeoutError instead of hanging."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    held = []

    def accept_and_hold():
        conn, _ = lsock.accept()
        conn.recv(4)  # consume the magic, then go silent
        held.append(conn)

    t = threading.Thread(target=accept_and_hold, daemon=True)
    t.start()
    c = StreamClient(port=lsock.getsockname()[1], timeout=0.5)
    with pytest.raises(TimeoutError):
        c.process_frame(np.zeros(HOP, np.float32))
    c.close()
    t.join(5)
    for conn in held:
        conn.close()
    lsock.close()


@pytest.mark.parametrize("direction", ["jax client, port server", "port client, jax server"])
def test_wire_compatible_with_jax(models, server, rng, direction):
    """The two packages speak one protocol: JAX's client against the port's
    server, and the port's client against JAX's server, on the same audio,
    each within 1e-5 of JAX's runtime."""
    jm, jd, _, _ = models
    audio = _audio(rng, 1, HOP * 4)
    ref = jax_reference(jm, jd, audio)[0]
    if direction.startswith("jax client"):
        got = stream(server.port, audio[0], client=JStreamClient)
    else:
        jsrv = JStreamServer(jm, jd, port=0, batch_window_ms=0.0)
        jsrv.start()
        try:
            got = stream(jsrv._sock.getsockname()[1], audio[0], hops_a_request=2,
                         client=StreamClient)
        finally:
            jsrv.stop()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_measure_chip_tick_needs_a_card(server):
    """The CPU server has no device tick to time: it raises, not a host
    number under a device name."""
    with pytest.raises(RuntimeError, match="CPU"):
        server.measure_chip_tick(2)


def test_mesh_must_divide_slots(models):
    from deepfilternet_torch.parallel import Mesh

    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="divide"):
        StreamServer(models[2], models[3], port=0, max_streams=3, mesh=Mesh((cpu, cpu)))


# -- on a card: the tick as one CUDA graph -----------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_tick_matches_eager_tick(cuda_device, rng):
    """On a card each tick is one replay of the graph captured in the
    constructor (the fused frontend kernel inside it), and a client's output
    equals the eager per-frame runtime on the card."""
    from deepfilternet_torch.enhance import init_df
    from deepfilternet_torch.streaming import StreamingRuntime
    from tests._torch_serving import MODEL_DIR

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tm, td, _ = init_df(MODEL_DIR, device=cuda_device)
    audio = _audio(rng, 1, HOP * 8)
    with torch_server(tm, td, max_streams=4, batch_window_ms=0.0) as srv:
        assert srv.graph_captures == 1 and srv.k1_in_graph == [1]
        got = stream(srv.port, audio[0])
        assert srv.graph_replays == srv.dispatches == 8
        assert srv.measure_chip_tick(5) > 0
        assert srv.graph_replays == 8  # timing replays are not ticks
    rt = StreamingRuntime(tm, td)
    _, ref = rt.process(rt.init(1), audio)
    np.testing.assert_allclose(got, ref.cpu().numpy()[0], rtol=0, atol=ATOL)
