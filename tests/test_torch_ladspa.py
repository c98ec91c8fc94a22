"""The LADSPA plugin (`native/ladspa_df.c`) against the port's server: the
cases of `tests/test_ladspa.py`. The plugin is built here into a temporary
directory with the Makefile's flags, hosted through ctypes, and its output
held against JAX's `StreamingRuntime.process` of the same audio at atol 1e-5,
one buffering hop later."""

import ctypes
import os
import subprocess

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests._torch_serving import (  # noqa: E402
    ATOL,
    HOP,
    NATIVE,
    jax_reference,
    load_models,
    port_config,
    torch_server,
)


class _PortRangeHint(ctypes.Structure):
    _fields_ = [("HintDescriptor", ctypes.c_int),
                ("LowerBound", ctypes.c_float),
                ("UpperBound", ctypes.c_float)]


class _Descriptor(ctypes.Structure):
    pass


_Handle = ctypes.c_void_p
_Descriptor._fields_ = [
    ("UniqueID", ctypes.c_ulong),
    ("Label", ctypes.c_char_p),
    ("Properties", ctypes.c_int),
    ("Name", ctypes.c_char_p),
    ("Maker", ctypes.c_char_p),
    ("Copyright", ctypes.c_char_p),
    ("PortCount", ctypes.c_ulong),
    ("PortDescriptors", ctypes.POINTER(ctypes.c_int)),
    ("PortNames", ctypes.POINTER(ctypes.c_char_p)),
    ("PortRangeHints", ctypes.POINTER(_PortRangeHint)),
    ("ImplementationData", ctypes.c_void_p),
    ("instantiate", ctypes.CFUNCTYPE(_Handle, ctypes.POINTER(_Descriptor), ctypes.c_ulong)),
    ("connect_port", ctypes.CFUNCTYPE(None, _Handle, ctypes.c_ulong,
                                      ctypes.POINTER(ctypes.c_float))),
    ("activate", ctypes.CFUNCTYPE(None, _Handle)),
    ("run", ctypes.CFUNCTYPE(None, _Handle, ctypes.c_ulong)),
    ("run_adding", ctypes.c_void_p),
    ("set_run_adding_gain", ctypes.c_void_p),
    ("deactivate", ctypes.c_void_p),
    ("cleanup", ctypes.CFUNCTYPE(None, _Handle)),
]


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    with port_config():
        yield


@pytest.fixture(scope="module")
def plugin_lib(tmp_path_factory):
    """`native/ladspa_df.so` built into a temporary directory, as the
    Makefile builds it (`$(CC) $(CFLAGS) -shared`, CFLAGS -O2 -fPIC -Wall)."""
    out = tmp_path_factory.mktemp("ladspa") / "ladspa_df.so"
    subprocess.run([os.environ.get("CC", "cc"), "-O2", "-fPIC", "-Wall", "-shared", "-o",
                    str(out), "ladspa_df.c", "df_client.c"],
                   cwd=NATIVE, check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.ladspa_descriptor.restype = ctypes.POINTER(_Descriptor)
    lib.ladspa_descriptor.argtypes = [ctypes.c_ulong]
    return lib


@pytest.fixture(scope="module")
def server():
    jm, jd, tm, td = load_models()
    with torch_server(tm, td) as srv:
        yield jm, jd, srv.port


def _run_plugin(lib, desc_idx, port, channels, monkeypatch, block=256):
    """Drive [C, T] audio through the plugin in `block`-sample chunks."""
    desc = lib.ladspa_descriptor(desc_idx).contents
    monkeypatch.setenv("DF_SERVER_HOST", "127.0.0.1")
    monkeypatch.setenv("DF_SERVER_PORT", str(port))
    handle = desc.instantiate(ctypes.byref(desc), 48000)
    assert handle
    nch = channels.shape[0]
    bufs_in = [(ctypes.c_float * block)() for _ in range(nch)]
    bufs_out = [(ctypes.c_float * block)() for _ in range(nch)]
    latency = ctypes.c_float(0.0)
    for c in range(nch):
        desc.connect_port(handle, c, bufs_in[c])
        desc.connect_port(handle, nch + c, bufs_out[c])
    desc.connect_port(handle, 2 * nch,
                      ctypes.cast(ctypes.byref(latency), ctypes.POINTER(ctypes.c_float)))
    desc.activate(handle)
    out = np.zeros_like(channels)
    for start in range(0, channels.shape[1] - block + 1, block):
        for c in range(nch):
            bufs_in[c][:] = channels[c, start: start + block].tolist()
        desc.run(handle, block)
        for c in range(nch):
            out[c, start: start + block] = np.frombuffer(bytearray(bufs_out[c]), np.float32)
    desc.cleanup(handle)
    return out, float(latency.value)


def test_descriptors(plugin_lib):
    mono = plugin_lib.ladspa_descriptor(0).contents
    stereo = plugin_lib.ladspa_descriptor(1).contents
    assert mono.Label == b"deep_filter_mono" and mono.PortCount == 3
    assert stereo.Label == b"deep_filter_stereo" and stereo.PortCount == 5
    assert not plugin_lib.ladspa_descriptor(2)


@pytest.mark.parametrize("desc_idx,n_ch,hops,block", [(0, 1, 8, 256), (1, 2, 4, 480)],
                         ids=["mono", "stereo"])
def test_plugin_matches_jax(plugin_lib, server, rng, monkeypatch, desc_idx, n_ch, hops, block):
    """Mono (blocks of 256, not a divisor of the hop) and stereo (channels as
    independent streams): the plugin's output is JAX's runtime output delayed
    by one buffering hop, after a primed hop of silence."""
    jm, jd, port = server
    audio = (rng.standard_normal((n_ch, HOP * hops)) * 0.1).astype(np.float32)
    got, latency = _run_plugin(plugin_lib, desc_idx, port, audio, monkeypatch, block=block)
    assert latency == 2 * HOP  # 20 ms in all, as the reference plugin
    expected = jax_reference(jm, jd, audio)
    n = (audio.shape[1] // block) * block - HOP
    np.testing.assert_allclose(got[:, HOP: HOP + n], expected[:, :n], rtol=0, atol=ATOL)
    assert np.allclose(got[:, :HOP], 0.0)


def test_bypass_without_server(plugin_lib, monkeypatch):
    monkeypatch.setenv("DF_SERVER_PORT", "1")  # nothing listens here
    desc = plugin_lib.ladspa_descriptor(0).contents
    handle = desc.instantiate(ctypes.byref(desc), 48000)
    buf_in = (ctypes.c_float * 64)(*([0.5] * 64))
    buf_out = (ctypes.c_float * 64)()
    desc.connect_port(handle, 0, buf_in)
    desc.connect_port(handle, 1, buf_out)
    desc.activate(handle)
    desc.run(handle, 64)
    desc.cleanup(handle)
    assert np.allclose(np.frombuffer(bytearray(buf_out), np.float32), 0.5)
