"""Conservative voice-capacity classes — host-side kernel gating.

The reference skips inactive voices per sample via ``is_active``
(graph/traits.rs:44-52).  Here the voices are a batch axis computed
branchlessly, and learning that a release tail finished would need a
device→host sync per block.  Instead, the host already knows everything
it needs *conservatively*: which voices hold notes (the allocator's
tables) and a worst-case release-tail timer after each note-off.

:class:`VoiceClassHost` compiles one variant of a polyphonic graph per
capacity class (e.g. 128 and 256 voices) and, between blocks, switches to
the smallest class that fits every *maybe-live* voice:

- **down-switch**: busy voices are compacted to the front (a host-chosen
  permutation applied to per-voice device state, host handler instances
  and the allocator tables), idle tails beyond the class boundary are
  dropped — by construction they are ``tail_seconds`` past release, i.e.
  below the audibility threshold the caller chose;
- **up-switch**: happens *before* a block whose pending note-ons could
  overflow the current class (so allocator stealing behaves exactly as
  the full-capacity graph), new slots start from pristine init state.

The voice kernels' work scales with the class size, so a smaller class
saves device time whenever few voices are live, for zero device syncs.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional

import jax
import numpy as np

from ..nodes.voice_allocator import VoiceAllocator

__all__ = ["VoiceClassHost"]


class VoiceClassHost:
    def __init__(self, build_graph: Callable[[int], "object"],
                 capacities=(128, 256), sample_rate: float = 48000.0,
                 block_size: int = 512, mode: str = "block",
                 tail_seconds: float = 1.0):
        self.capacities = sorted(int(c) for c in capacities)
        self.variants = {
            c: build_graph(c).compile(sample_rate, block_size=block_size,
                                      mode=mode)
            for c in self.capacities}
        self.active_cap = self.capacities[-1]
        self.tail_frames = int(tail_seconds * sample_rate)
        self.switches = 0
        # voice-array node names (count equals the variant capacity) and
        # the allocator node, resolved per variant
        self._voice_nodes: Dict[int, List[str]] = {}
        self._alloc_name: Optional[str] = None
        for c, comp in self.variants.items():
            names = [n for n, inst in comp.ir.nodes.items()
                     if inst.count == c]
            self._voice_nodes[c] = names
            for n, inst in comp.ir.nodes.items():
                if isinstance(inst.node, VoiceAllocator):
                    self._alloc_name = n
        if self._alloc_name is None:
            raise ValueError("graph has no VoiceAllocator — voice classes "
                             "need host-visible note tracking")
        # pristine per-voice init state for up-switch padding
        self._init_state = {
            c: comp.prog.init_device_state()
            for c, comp in self.variants.items()}

    # ------------------------------------------------------------------ #
    @property
    def compiled(self):
        return self.variants[self.active_cap]

    def queue_event(self, name, frame_offset, payload):
        self.compiled.queue_event(name, frame_offset, payload)

    def set_value(self, name, v):
        for comp in self.variants.values():
            comp.set_value(name, v)

    # ------------------------------------------------------------------ #
    def _alloc(self, cap: int) -> VoiceAllocator:
        comp = self.variants[cap]
        insts = comp.prog.host_instances.get(self._alloc_name)
        return insts[0] if insts else comp.ir.nodes[self._alloc_name].node

    def _pending_note_ons(self) -> int:
        from ..core.events import NoteOnEvent
        n = 0
        for q in self.compiled._event_queues.values():
            for ev in q:
                data = getattr(ev.payload, "bytes", None)  # raw MIDI
                if data is not None and len(data) >= 3 \
                        and (data[0] & 0xF0) == 0x90 and data[2] > 0:
                    n += 1
                elif isinstance(ev.payload, NoteOnEvent):
                    n += 1
        return n

    def _switch(self, target: int) -> None:
        src = self.compiled
        dst = self.variants[target]
        cur_cap = self.active_cap
        alloc = self._alloc(cur_cap)
        busy = alloc.busy_mask(self.tail_frames)
        order = [i for i, b in enumerate(busy) if b] + \
                [i for i, b in enumerate(busy) if not b]
        if target >= cur_cap:
            order = list(range(cur_cap))  # up-switch: keep layout
        alloc.permute(order)

        # device state: voice-array nodes gather/permute their leading
        # axis; everything else copies through
        take = min(cur_cap, target)
        perm = np.asarray(order[:take], np.int32)
        new_state = dict(self._init_state[target])
        for name, sub in src.state.items():
            if name in ("__fb__", "__rs__"):
                new_state[name] = sub  # rebuilt below if per-voice
                continue
            if name in self._voice_nodes[cur_cap]:
                init = self._init_state[target][name]

                def move(leaf, ini):
                    leaf = jax.numpy.asarray(leaf)[perm]
                    if target > take:
                        leaf = jax.numpy.concatenate(
                            [leaf, jax.numpy.asarray(ini)[take:]], axis=0)
                    return leaf
                new_state[name] = jax.tree_util.tree_map(move, sub, init)
            else:
                new_state[name] = sub
        # feedback carries / resampler histories: per-voice entries keyed
        # by node name
        for special in ("__fb__", "__rs__"):
            if special not in src.state:
                continue
            ns = {}
            for k, v in src.state[special].items():
                node = k.rsplit(".", 1)[0] if special == "__fb__" else None
                if node in self._voice_nodes[cur_cap]:
                    ini = self._init_state[target][special][k]
                    v = jax.numpy.asarray(v)[perm]
                    if target > take:
                        v = jax.numpy.concatenate(
                            [v, jax.numpy.asarray(ini)[take:]], axis=0)
                ns[k] = v
            new_state[special] = ns
        dst.state = new_state

        # host handler instances (per-voice control state)
        for name in self._voice_nodes[cur_cap]:
            insts = src.prog.host_instances.get(name)
            if not insts:
                continue
            dst_insts = dst.prog.host_instances[name]
            for j in range(take):
                dst_insts[j].restore_host_state(
                    insts[order[j]].host_state())
            for j in range(take, target):
                dst_insts[j].reset()

        # allocator tables: truncate/extend the permuted table
        src_alloc = alloc
        dst_alloc = self._alloc(target)
        snap = src_alloc.host_state()
        st = snap["_state"][:take]
        from ..nodes.voice_allocator import _VoiceState
        while len(st) < target:
            st.append(_VoiceState())
        dst_alloc._state = st
        dst_alloc._age = snap["_age"]
        dst_alloc._frames = snap["_frames"]

        # params / ramps stay continuous across the switch
        for pname, r in src._params.items():
            d = dst._params[pname]
            d.current, d.target = r.current, r.target
            d.increment = r.increment
            d.frames_remaining = r.frames_remaining
        # pending events move over
        for qname, q in src._event_queues.items():
            dst._event_queues[qname].extend(q)
            q.clear()
        dst._control_dirty = True
        src._control_dirty = True
        self.active_cap = target
        self.switches += 1

    # ------------------------------------------------------------------ #
    def process_block(self, *a, **kw):
        # up-switch BEFORE the block if pending note-ons could overflow
        # (so stealing semantics match the full-capacity graph)
        alloc = self._alloc(self.active_cap)
        busy_n = sum(alloc.busy_mask(self.tail_frames))
        need = busy_n + self._pending_note_ons()
        if need > self.active_cap:
            for c in self.capacities:
                if c >= min(need, self.capacities[-1]):
                    if c > self.active_cap:
                        self._switch(c)
                    break
        out = self.compiled.process_block(*a, **kw)
        # down-switch after: smallest class holding every busy voice
        alloc = self._alloc(self.active_cap)
        busy_n = sum(alloc.busy_mask(self.tail_frames))
        for c in self.capacities:
            if c >= busy_n and c < self.active_cap:
                self._switch(c)
                break
        return out
