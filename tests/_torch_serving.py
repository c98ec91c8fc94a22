"""Helpers shared by the port's serving tests (`tests/test_torch_serve*.py`,
`test_torch_ladspa.py`, `test_torch_demo_client.py`, `test_torch_parallel.py`):
the demo checkpoint loaded into both packages, JAX's `StreamingRuntime` as
the reference, and the port's server on an ephemeral port."""

import contextlib
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(REPO, "pretrained", "dfn3_fixture_demo")
NATIVE = os.path.join(REPO, "native")
HOP = 480
# the JAX server tests' bound: one stream through a server against the runtime
ATOL = 1e-5


@contextlib.contextmanager
def port_config():
    """Reset the port's global config; run torch on one CPU thread (the
    per-frame ops are tiny, and the suite runs several workers at once)."""
    import torch

    from deepfilternet_torch.config import config

    config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def load_models():
    """(JAX model, JAX df_state, port model on the CPU, port df_state), both
    from the demo checkpoint."""
    from deepfilternet_tpu.enhance import init_df as j_init_df
    from deepfilternet_torch.enhance import init_df

    jm, jd, _ = j_init_df(MODEL_DIR)
    tm, td, _ = init_df(MODEL_DIR, device="cpu")
    return jm, jd, tm, td


def jax_reference(jm, jd, audio: np.ndarray, **runtime_params) -> np.ndarray:
    """JAX's `StreamingRuntime.process` of [S, T] audio from a fresh carry."""
    import jax.numpy as jnp

    from deepfilternet_tpu.streaming import RuntimeParams, StreamingRuntime

    rt = StreamingRuntime(jm, jd, RuntimeParams(**runtime_params))
    _, out = rt.process(rt.init(audio.shape[0]), jnp.asarray(audio))
    return np.asarray(out)


@contextlib.contextmanager
def torch_server(tm, td, **kw):
    """The port's StreamServer on an ephemeral port, stopped on exit."""
    from deepfilternet_torch.serve import StreamServer

    srv = StreamServer(tm, td, port=0, **kw).start()
    try:
        yield srv
    finally:
        srv.stop()


def stream(port, audio: np.ndarray, hops_a_request: int = 1, client=None) -> np.ndarray:
    """One client streams 1-D `audio` through the server at `port`, a request
    of `hops_a_request` hops at a time; returns the concatenated replies."""
    if client is None:
        from deepfilternet_torch.serve import StreamClient as client
    c = client(port=port)
    step = HOP * hops_a_request
    try:
        return np.concatenate([c.process_frame(audio[i: i + step])
                               for i in range(0, audio.size, step)])
    finally:
        c.close()
