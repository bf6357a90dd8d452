"""Voice-axis sharding over a device mesh.

The reference is single-threaded per graph; its voice axis is a node array
looped per sample (SURVEY §2.7).  Here voices are a leading batch axis, and
scale-out beyond one card shards that axis over the device mesh with
``jax.sharding.NamedSharding`` — the FanIn mix-down edge (a sum over the
voice axis) lowers to an XLA all-reduce (psum) automatically.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["voice_mesh", "shard_compiled_state", "voice_sharding"]


def voice_mesh(n_devices: Optional[int] = None,
               axis_name: str = "voices") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def voice_sharding(mesh: Mesh, axis_name: str = "voices") -> NamedSharding:
    return NamedSharding(mesh, P(axis_name))


def shard_compiled_state(compiled, mesh: Mesh, voice_nodes=None,
                         axis_name: str = "voices"):
    """Place a CompiledGraph's device state on ``mesh``, sharding the
    leading (voice) axis of every node-array state leaf and replicating
    everything else.

    In block mode this also switches execution to SPMD ``shard_map``
    over the mesh (``CompiledGraph.enable_sharding``): each device runs
    the block body — including the voice kernels — on its local voice
    shard, per-block inputs and event buffers are sliced per device, and
    the FanIn mix-down finishes with an explicit ``psum`` (NCCL across
    GPUs).  Sample mode keeps placement-only sharding (GSPMD inserts
    the collectives)."""
    if getattr(compiled, "mode", None) == "block":
        compiled.enable_sharding(mesh, axis_name)
    ir = compiled.ir
    counts = {name: inst.count for name, inst in ir.nodes.items()
              if inst.count > 1 and (voice_nodes is None
                                     or name in voice_nodes)}
    repl = NamedSharding(mesh, P())

    new_state: Dict[str, Any] = {}
    for name, sub in compiled.state.items():
        count = counts.get(name)

        def place(x, count=count):
            x = jax.numpy.asarray(x)
            if count is not None and x.ndim >= 1 and x.shape[0] == count \
                    and count % mesh.devices.size == 0:
                spec = P(axis_name, *([None] * (x.ndim - 1)))
                return jax.device_put(x, NamedSharding(mesh, spec))
            return jax.device_put(x, repl)

        new_state[name] = jax.tree_util.tree_map(place, sub)
    compiled.state = new_state
    return compiled
