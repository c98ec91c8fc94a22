"""Stream sharding over several devices for batched streaming inference.

The port of `deepfilternet_tpu/parallel/streams.py`. Independent audio
streams split over the devices of a `Mesh`: each device runs its own
`StreamingRuntime` on its contiguous share of the streams, with the model's
weights copied to it once, and there is no traffic between devices on the
hot path. The carry is one `StreamCarry` a device; outputs are joined in
stream order on the mesh's first device. The shards are driven one after the
other from the calling thread: kernels queue asynchronously on each device,
but the per-frame loop's host cost adds up over the shards (the stream
server's graph ticks, `serve.py`, cut that cost to one replay a shard).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from deepfilternet_torch.parallel.mesh import Mesh, data_parallel_mesh, shard_params, split_rows
from deepfilternet_torch.streaming import RuntimeParams, StreamCarry, StreamingRuntime


class ShardedStreamingRuntime:
    """`StreamingRuntime` with its streams split over the devices of a mesh.

    The stream count must divide over the devices (ValueError otherwise).
    API as `StreamingRuntime`, with the carry a list of one `StreamCarry` a
    device.
    """

    def __init__(self, model, df_state, mesh: Optional[Mesh] = None,
                 params: RuntimeParams = RuntimeParams(),
                 dtype: torch.dtype = torch.float32):
        self.mesh = mesh or data_parallel_mesh()
        trees = shard_params((model.params, model.state), self.mesh)
        self.runtimes = [
            StreamingRuntime(dataclasses.replace(model, params=p, state=s, device=d, _cache={}),
                             df_state, params, dtype)
            for (p, s), d in zip(trees, self.mesh.devices)
        ]
        self.device = self.mesh.devices[0]

    def init(self, n_streams: int) -> List[StreamCarry]:
        parts = split_rows(n_streams, self.mesh)
        return [rt.init(p.stop - p.start) for rt, p in zip(self.runtimes, parts)]

    def _split(self, carry: List[StreamCarry], audio) -> List:
        audio = self.runtimes[0]._audio(audio)
        parts = split_rows(audio.shape[0], self.mesh)
        if len(carry) != self.mesh.size:
            raise ValueError(f"{len(carry)} carries for {self.mesh.size} devices")
        return [audio[p] for p in parts]

    def _join(self, results) -> Tuple[List[StreamCarry], torch.Tensor]:
        carries = [c for c, _ in results]
        return carries, torch.cat([o.to(self.device) for _, o in results], dim=0)

    def process(self, carry: List[StreamCarry], audio) -> Tuple[List[StreamCarry], torch.Tensor]:
        """audio: [S, T] with T a multiple of hop -> (carries', [S, T] enhanced)."""
        chunks = self._split(carry, audio)
        return self._join([rt.process(c, a) for rt, c, a in zip(self.runtimes, carry, chunks)])

    def process_frame(self, carry: List[StreamCarry], frame
                      ) -> Tuple[List[StreamCarry], torch.Tensor]:
        """frame: [S, hop] -> (carries', enhanced [S, hop])."""
        chunks = self._split(carry, frame)
        return self._join([rt.process_frame(c, a)
                           for rt, c, a in zip(self.runtimes, carry, chunks)])
