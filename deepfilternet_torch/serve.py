"""Streaming enhancement server: audio clients connect over TCP, claim a
stream slot and exchange 10 ms hops.

The port of `deepfilternet_tpu/serve.py`, with the same wire protocol, slot
pool, batcher and fetcher. Per-stream state (STFT memories, norm trackers,
GRU hiddens, DF ring) lives server-side in a fixed `max_streams` slot pool;
one batcher thread gathers every pending hop each tick into one device
program and leaves idle slots' carry as it was. `server.dispatches` against
`server.frames_processed` shows the batching achieved.

Wire protocol (little-endian):
    client -> server:  u32 magic 0x44465331 ("DFS1"), then per frame:
                       u32 n_samples, f32 x n_samples  (must be k*hop)
    server -> client:  u32 n_samples, f32 x n_samples  (enhanced, delayed
                       by fft-hop samples as in the reference runtime)
    n_samples == 0 closes the stream. A partial hop, or a full slot pool,
    is answered with n_samples == 0.

A tick is the reset select (slots that connected since the last tick take
the pristine carry), the streaming cell over all slots (`StreamingRuntime`,
whose frontend is the fused frontend kernel) and the active select (idle
slots keep their pre-cell carry). On a CUDA device the tick is captured once,
in the constructor, as one CUDA graph on static buffers: the carry, the
pristine carry, the input rows and the output. The graph writes the new carry
back into the static carry, which is what the JAX server's donated carry
does. Each tick copies its input rows from a ring of `max_inflight` pinned
host buffers, replays the graph once and copies the output into a pinned ring
slot behind an event; the fetcher waits on that event, so the batcher never
waits on the device. On the CPU the same tick runs eagerly. A failed capture
raises: a CUDA server never ticks eagerly.

Tracing (utils/timings.py): the spans `serve.handler_wait` (a handler's
wait for its hop's output), inside it `serve.queue` (from the hop's arrival
among the pending hops to the tick that takes it), `serve.submit` (the
batcher enqueues a tick), `serve.fetch` (the fetcher waits for a tick's
output) and `serve.reply` (the handler sends it). `StreamServer.stats()`
gives the counters and the bounded logs' percentiles.

Run: python -m deepfilternet_torch.serve [--port 7860] [--device cpu] [...]
"""

from __future__ import annotations

import argparse
import queue
import socket
import struct
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from deepfilternet_torch.utils.timings import span, tracing

MAGIC = 0x44465331


class _Req:
    """One pending hop for one slot: `event` is set when its output is in
    `out`; `taken`, made only while a profiler records (for the span
    `serve.queue`), when a tick takes it."""

    __slots__ = ("audio", "out", "event", "taken", "t_arrival")

    def __init__(self, audio: np.ndarray):
        self.audio = audio
        self.out: Optional[np.ndarray] = None
        self.event = threading.Event()
        self.taken: Optional[threading.Event] = threading.Event() if tracing() else None
        self.t_arrival = 0.0


def _percentiles(log: deque) -> Dict:
    """count, p50 and p95 of a bounded log (copied at once: `deque.copy`
    holds the interpreter lock, so appends from other threads cannot cut in)."""
    v = list(log.copy())
    if not v:
        return dict(count=0, p50=None, p95=None)
    p50, p95 = np.percentile(v, [50, 95])
    return dict(count=len(v), p50=float(p50), p95=float(p95))


def _stream_axes(rt) -> List[int]:
    """Each carry leaf's stream axis (GRU hiddens are [L, S, H]), found by
    diffing the shapes of two carries."""
    axes = []
    for x, y in zip(pytree.tree_leaves(rt.init(3)), pytree.tree_leaves(rt.init(4))):
        diff = [i for i, (p, q) in enumerate(zip(x.shape, y.shape)) if p != q]
        if len(diff) != 1:
            raise ValueError(f"no single stream axis between {x.shape} and {y.shape}")
        axes.append(diff[0])
    return axes


def _mask_select(mask, new, old, axes):
    """Per leaf, `new` where the slot's mask is set, else `old`, along each
    leaf's stream axis."""
    out = []
    for n, o, ax in zip(new, old, axes):
        m = mask.reshape((1,) * ax + (-1,) + (1,) * (n.ndim - ax - 1))
        out.append(torch.where(m, n, o))
    return out


class _TickShard:
    """One device's share of the slot pool: its runtime, its carry and its
    tick, with (on a CUDA device) the captured graph and the rings.

    The tick's input is one [slots, hop + 2] float32 row block: a slot's hop,
    then its active and reset flags.
    """

    def __init__(self, rt, n_slots: int, hop: int, ring: int):
        self.rt, self.hop = rt, hop
        self.device = rt.device
        self._leaves, self._spec = pytree.tree_flatten(rt.init(n_slots))
        self._init = pytree.tree_leaves(rt.init(n_slots))
        self._axes = _stream_axes(rt)
        self._in = torch.zeros((n_slots, hop + 2), device=self.device)
        self.graph = None
        self.k1_in_graph = 0  # fused frontend launches recorded in the graph
        self.replays = 0  # graph replays made by submit (ticks, not timing runs)
        if self.device.type == "cuda":
            self._capture()
        pin = self.device.type == "cuda"
        self._host_in = [torch.zeros((n_slots, hop + 2), pin_memory=pin) for _ in range(ring)]
        self._host_out = [torch.zeros((n_slots, hop), pin_memory=pin) for _ in range(ring)]
        self._done = [torch.cuda.Event() for _ in range(ring)] if pin else None

    @torch.no_grad()
    def _step(self) -> torch.Tensor:
        """The tick on the static buffers: reset select, the cell over all
        slots, active select; the new carry is written into the static carry.
        Returns the output [slots, hop]."""
        hop = self.hop
        active, reset = self._in[:, hop] > 0.5, self._in[:, hop + 1] > 0.5
        c0 = _mask_select(reset, self._init, self._leaves, self._axes)
        c1, out = self.rt.process_frame(pytree.tree_unflatten(c0, self._spec),
                                        self._in[:, :hop].contiguous())
        new = _mask_select(active, pytree.tree_leaves(c1), c0, self._axes)
        for dst, src in zip(self._leaves, new):
            dst.copy_(src)
        return out

    def _capture(self):
        """Warm the tick up eagerly on a side stream (it builds the kernel,
        the library handles and the device constants, whose host-to-device
        copies a capture forbids), then capture it as one graph. No slot is
        active in the warm-up, so the carry stays pristine."""
        from deepfilternet_torch.ops.fused_frontend import fused_analysis_frontend as k1

        self.stream = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device):
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                for _ in range(3):
                    self._step()
            self.stream.synchronize()
            before = k1.launches
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=self.stream):
                self._out = self._step()
            self.k1_in_graph = k1.launches - before

    def input_rows(self, idx: int) -> np.ndarray:
        """Ring slot `idx`'s input rows as a zeroed numpy view to fill."""
        rows = self._host_in[idx].numpy()
        rows[:] = 0.0
        return rows

    def submit(self, idx: int):
        """Run one tick on ring slot `idx`'s input rows. CPU: eagerly, the
        output ready on return. CUDA: enqueued (copy in, one graph replay,
        copy out, event), no wait on the device."""
        if self.graph is None:
            self._in.copy_(self._host_in[idx])
            self._host_out[idx].copy_(self._step())
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self._in.copy_(self._host_in[idx], non_blocking=True)
            self.graph.replay()
            self.replays += 1
            self._host_out[idx].copy_(self._out, non_blocking=True)
            self._done[idx].record(self.stream)

    def fetch(self, idx: int) -> np.ndarray:
        """Ring slot `idx`'s output rows, copied out once the tick is done."""
        if self._done is not None:
            self._done[idx].synchronize()
        return self._host_out[idx].numpy().copy()

    def time_replays(self, n: int) -> float:
        """Device ms of one replay over `n` chained replays with every slot
        active on zero audio (CUDA events); the carry is restored after."""
        hop = self.hop
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            saved = [x.clone() for x in self._leaves]
            self._in.zero_()
            self._in[:, hop] = 1.0
            self.graph.replay()
            start.record(self.stream)
            for _ in range(n):
                self.graph.replay()
            end.record(self.stream)
            for x, s in zip(self._leaves, saved):
                x.copy_(s)
        end.synchronize()
        return start.elapsed_time(end) / n


class StreamServer:
    """Dynamic-batching stream server over a fixed slot pool.

    A batcher thread owns the [max_streams]-wide carry. Connection handlers
    enqueue one 10 ms hop per tick; each tick gathers every pending hop into
    one device program per device shard (see the module's note) and hands
    its output to a fetcher thread that fans the results back out. Idle
    slots take part with zero audio but keep their carry, so a silent
    client's stream state never advances.

    `mesh` (a `parallel.Mesh`) splits the slot pool over its devices, each
    with its own copy of the weights and its own graph; `max_streams` must
    divide over them.
    """

    def __init__(self, model, df_state, host="127.0.0.1", port=7860,
                 runtime_params=None, max_streams: int = 16,
                 batch_window_ms: float = 1.0, max_inflight: int = 3, mesh=None):
        from deepfilternet_torch.streaming import RuntimeParams, StreamingRuntime

        params = runtime_params or RuntimeParams()
        if mesh is not None:
            from deepfilternet_torch.parallel.streams import ShardedStreamingRuntime

            if max_streams % mesh.size:
                raise ValueError(f"max_streams={max_streams} must divide over "
                                 f"{mesh.size} devices")
            runtimes = ShardedStreamingRuntime(model, df_state, mesh, params).runtimes
        else:
            runtimes = [StreamingRuntime(model, df_state, params)]
        self.hop = df_state.hop_size
        self.host = host
        self.port = port
        self.max_streams = max_streams
        self.batch_window = batch_window_ms / 1e3
        self._sock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

        self._per_shard = max_streams // len(runtimes)
        self._shards = [_TickShard(rt, self._per_shard, self.hop, max_inflight)
                        for rt in runtimes]
        self._free = deque(range(max_streams))
        self._reset_pending: set = set()
        self._pending: Dict[int, _Req] = {}
        self._cv = threading.Condition()
        # the rings' free slots: a tick takes one, the fetcher returns it
        # once the tick's output is copied out, so at most max_inflight ticks
        # are in flight and no pinned buffer is rewritten while in use
        self._ring_free: queue.Queue = queue.Queue()
        for i in range(max_inflight):
            self._ring_free.put(i)
        self._fetchq: queue.Queue = queue.Queue()
        self._tick_lock = threading.Lock()
        # observability. dispatch_times records submit -> output-on-host wall
        # seconds per tick, tick_host_times the batcher's host seconds from
        # taking a batch to the tick enqueued, queue_wait_times each hop's
        # seconds from its arrival among the pending hops to the tick that
        # takes it (all bounded); measure_chip_tick() gives the device's.
        self.dispatches = 0
        self.frames_processed = 0
        self.dispatch_times: deque = deque(maxlen=10_000)
        self.tick_host_times: deque = deque(maxlen=10_000)
        self.queue_wait_times: deque = deque(maxlen=10_000)
        self.graph_captures = sum(s.graph is not None for s in self._shards)
        self.error: Optional[BaseException] = None

    @property
    def graph_replays(self) -> int:
        """Graph replays the ticks made, summed over the device shards
        (`measure_chip_tick`'s are not counted)."""
        return sum(s.replays for s in self._shards)

    @property
    def k1_in_graph(self) -> List[int]:
        """Fused frontend launches recorded in each shard's graph."""
        return [s.k1_in_graph for s in self._shards]

    def stats(self) -> Dict:
        """What the server has done so far: `dispatches` (ticks), `frames`
        (hops processed), `graph_replays`, and the count, p50 and p95 in
        seconds of the last 10,000 of each log: `tick_host_s` (the batcher's
        host time a tick), `dispatch_s` (a tick from its submit to its
        output on the host) and `queue_wait_s` (a hop's wait for the tick
        that takes it)."""
        return dict(dispatches=self.dispatches, frames=self.frames_processed,
                    graph_replays=self.graph_replays,
                    tick_host_s=_percentiles(self.tick_host_times),
                    dispatch_s=_percentiles(self.dispatch_times),
                    queue_wait_s=_percentiles(self.queue_wait_times))

    # -- protocol ------------------------------------------------------------

    @staticmethod
    def _recv_exact(conn, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    # -- slot pool -----------------------------------------------------------

    def _alloc_slot(self) -> Optional[int]:
        with self._cv:
            if not self._free:
                return None
            slot = self._free.popleft()
            # no dispatch here: the reset rides the slot's first tick
            self._reset_pending.add(slot)
            return slot

    def _release_slot(self, slot: int):
        with self._cv:
            self._pending.pop(slot, None)
            self._free.append(slot)

    def _wait(self, event: threading.Event):
        while not event.wait(1.0):
            if self._stop.is_set():
                raise RuntimeError("server stopping")

    def _submit(self, slot: int, hop_audio: np.ndarray) -> np.ndarray:
        req = _Req(hop_audio)
        with span("serve.handler_wait"):
            with self._cv:
                req.t_arrival = time.perf_counter()
                self._pending[slot] = req
                self._cv.notify_all()
            if req.taken is not None:
                with span("serve.queue"):
                    self._wait(req.taken)
            self._wait(req.event)
        return req.out  # type: ignore[return-value]

    # -- batcher and fetcher -------------------------------------------------

    def _take_ring_slot(self) -> Optional[int]:
        while not self._stop.is_set():
            try:
                return self._ring_free.get(timeout=0.2)
            except queue.Empty:
                continue
        return None

    def _batch_loop(self):
        """Submit stage: gathers pending hops into one tick; never waits on
        the device (outputs drain through `_fetch_loop`)."""
        hop, n = self.hop, self._per_shard
        while not self._stop.is_set():
            with self._cv:
                if not self._pending:
                    self._cv.wait(0.05)
                    if not self._pending:
                        continue
            # short coalescing window so concurrent clients land in one tick
            if self.batch_window > 0:
                time.sleep(self.batch_window)
            with self._cv:
                batch, self._pending = self._pending, {}
                resets, self._reset_pending = self._reset_pending, set()
            t_take = time.perf_counter()
            for req in batch.values():
                self.queue_wait_times.append(t_take - req.t_arrival)
                if req.taken is not None:
                    req.taken.set()
            if not batch and not resets:
                continue
            idx = self._take_ring_slot()
            if idx is None:
                return
            t_host = time.perf_counter()
            rows = [s.input_rows(idx) for s in self._shards]
            for slot, req in batch.items():
                r = rows[slot // n][slot % n]
                r[:hop] = req.audio
                r[hop] = 1.0
            for slot in resets:
                rows[slot // n][slot % n, hop + 1] = 1.0
            t_disp = time.perf_counter()
            with self._tick_lock, span("serve.submit"):
                for s in self._shards:
                    s.submit(idx)
            self.tick_host_times.append(time.perf_counter() - t_host)
            self.dispatches += 1
            self.frames_processed += len(batch)
            self._fetchq.put((idx, batch, t_disp))

    def _fetch_loop(self):
        """Fetch stage: waits for each tick's output and fans it back out to
        the waiting connection handlers."""
        while not self._stop.is_set():
            try:
                idx, batch, t_disp = self._fetchq.get(timeout=0.2)
            except queue.Empty:
                continue
            with span("serve.fetch"):
                outs = [s.fetch(idx) for s in self._shards]
            self._ring_free.put(idx)
            out = np.concatenate(outs) if len(outs) > 1 else outs[0]
            self.dispatch_times.append(time.perf_counter() - t_disp)
            for slot, req in batch.items():
                req.out = out[slot]
                req.event.set()

    def _guarded(self, loop):
        """Run a server loop; a failure stops the server (handlers waiting on
        a hop then raise) and is kept in `self.error`."""
        try:
            loop()
        except Exception as e:  # noqa: BLE001 - the thread's boundary
            traceback.print_exc()
            self.error = e
            self._stop.set()

    def measure_chip_tick(self, n: int = 50) -> float:
        """Device-only cost of one server tick, in ms: `n` chained graph
        replays with every slot active, timed by CUDA events, the carry
        restored after (the largest over the device shards, which run side
        by side). Raises on a CPU server, which has no device tick."""
        if self.graph_captures != len(self._shards):
            raise RuntimeError("measure_chip_tick times CUDA graph replays; this server "
                               "runs on the CPU")
        with self._tick_lock:
            return max(s.time_replays(n) for s in self._shards)

    # -- connection handler ----------------------------------------------------

    def _handle(self, conn: socket.socket):
        slot = None
        try:
            hdr = self._recv_exact(conn, 4)
            if hdr is None or struct.unpack("<I", hdr)[0] != MAGIC:
                return
            slot = self._alloc_slot()
            if slot is None:
                conn.sendall(struct.pack("<I", 0))  # pool exhausted
                return
            while not self._stop.is_set():
                ln = self._recv_exact(conn, 4)
                if ln is None:
                    break
                n = struct.unpack("<I", ln)[0]
                if n == 0:
                    break
                if n % self.hop != 0:
                    conn.sendall(struct.pack("<I", 0))
                    break
                data = self._recv_exact(conn, n * 4)
                if data is None:
                    break
                audio = np.frombuffer(data, "<f4")
                outs = [self._submit(slot, audio[i: i + self.hop])
                        for i in range(0, n, self.hop)]
                out_np = np.concatenate(outs)
                with span("serve.reply"):
                    conn.sendall(struct.pack("<I", out_np.size) + out_np.tobytes())
        except (OSError, RuntimeError):
            pass  # the client went away, or the server is stopping
        finally:
            if slot is not None:
                self._release_slot(slot)
            conn.close()

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Bind (port 0 picks a free port, then kept in `self.port`) and start
        the accept, batcher and fetcher threads."""
        self._sock = socket.create_server((self.host, self.port))
        self._sock.settimeout(0.5)
        self.port = self._sock.getsockname()[1]
        for loop in (self._accept_loop, self._batch_loop, self._fetch_loop):
            t = threading.Thread(target=self._guarded, args=(loop,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def stop(self):
        """Stop accepting and ticking; waits (up to 5 s each) for the accept,
        batcher and fetcher threads to end."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._sock is not None:
            self._sock.close()
        for t in self._threads:
            t.join(5.0)


class StreamClient:
    """Minimal client mirroring the C API surface (df_create /
    df_process_frame / df_free)."""

    def __init__(self, host="127.0.0.1", port=7860, timeout=300.0):
        # A finite default timeout turns a dead server or a lost reply into a
        # socket.timeout instead of a recv that hangs forever (pass
        # timeout=None to opt out). It is generous because a cold server's
        # first reply may wait on the kernel's build.
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        self.sock.sendall(struct.pack("<I", MAGIC))

    def process_frame(self, audio: np.ndarray) -> np.ndarray:
        audio = np.ascontiguousarray(audio, np.float32).reshape(-1)
        self.sock.sendall(struct.pack("<I", audio.size) + audio.tobytes())
        n = struct.unpack("<I", StreamServer._recv_exact(self.sock, 4))[0]
        data = StreamServer._recv_exact(self.sock, n * 4)
        return np.frombuffer(data, "<f4").copy()

    def close(self):
        try:
            self.sock.sendall(struct.pack("<I", 0))
        except OSError:
            pass
        self.sock.close()


def main(argv=None):
    from deepfilternet_torch.enhance import DEFAULT_MODEL_DIR, init_df
    from deepfilternet_torch.streaming import RuntimeParams

    parser = argparse.ArgumentParser(description="DeepFilterNet stream server (PyTorch)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7860,
                        help="TCP port (0: any free port, printed on start)")
    parser.add_argument("--model-base-dir", "-m", default=None,
                        help="Directory with config.ini and checkpoints/, or a .tar.gz "
                             "archive of one (default: the bundled DFN3 demo checkpoint)")
    parser.add_argument("--pf", action="store_true")
    parser.add_argument("--atten-lim", type=float, default=0.0)
    parser.add_argument("--max-streams", type=int, default=16)
    parser.add_argument("--batch-window-ms", type=float, default=1.0)
    parser.add_argument("--ws-port", type=int, default=0,
                        help="also serve a WebSocket bridge + browser demo "
                             "page on this port (serve_ws.py)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    model_dir = args.model_base_dir or DEFAULT_MODEL_DIR
    model, df_state, _ = init_df(model_dir, post_filter=args.pf, device=args.device)
    rp = RuntimeParams(atten_lim_db=args.atten_lim,
                       post_filter_beta=0.02 if args.pf else 0.0)
    server = StreamServer(model, df_state, args.host, args.port, rp,
                          max_streams=args.max_streams,
                          batch_window_ms=args.batch_window_ms)
    server.start()
    print(f"Serving on {args.host}:{server.port} (frame = {df_state.hop_size} samples)",
          flush=True)
    bridge = None
    if args.ws_port:
        from deepfilternet_torch.serve_ws import WsBridge

        bridge = WsBridge(server, args.host, args.ws_port).start()
        print(f"Browser demo + WebSocket bridge on http://{args.host}:{args.ws_port}/",
              flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        if bridge is not None:
            bridge.stop()
        server.stop()


if __name__ == "__main__":
    main()
