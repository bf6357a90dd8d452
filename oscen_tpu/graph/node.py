"""Node contract — the JAX ``SignalProcessor``.

The reference node contract (graph/traits.rs:27-52) is: ``prepare()``
(recompute rate-derived state), ``process()`` (advance one sample, I/O via
struct fields).  Here a node is a *pure function* over an explicit state
pytree:

- :meth:`Node.init_state` — the ``prepare()`` analogue: build the state
  pytree (NumPy/Python scalars; becomes device arrays under jit).
- :meth:`Node.tick` — the ``process()`` analogue: one sample, all I/O via
  dicts of JAX values.  Used by the ``sample``-mode compiler, which fuses the
  whole graph into one ``lax.scan`` whose body replays the reference's exact
  per-sample schedule (op-order parity, voice-parallel).
- ``on_<endpoint>(state, value, sr)`` — event handlers, pure functions applied
  under a mask at the exact frame offset (sub-block-splitting parity).
- :meth:`Node.process_block` — optional time-vectorized implementation used
  by the ``block``-mode compiler (cumsum phases, associative scans, closed
  forms).  The default falls back to scanning :meth:`tick`.

Feedback: nodes that may legally break a cycle implement
``ALLOWS_FEEDBACK = True`` (reference graph/traits.rs:54-62; only Delay).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.events import EventBuffer, EventInstance
from ..core.types import Endpoint, Kind, SampleRate

State = Dict[str, Any]
Values = Dict[str, Any]


class Node:
    """Base class for device-domain signal processors."""

    INPUTS: Tuple[Endpoint, ...] = ()
    OUTPUTS: Tuple[Endpoint, ...] = ()
    ALLOWS_FEEDBACK: bool = False
    HOST: bool = False

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    def input(self, name: str) -> Endpoint:
        for e in self.INPUTS:
            if e.name == name:
                return e
        raise KeyError(f"{type(self).__name__} has no input '{name}'")

    def output(self, name: str) -> Endpoint:
        for e in self.OUTPUTS:
            if e.name == name:
                return e
        raise KeyError(f"{type(self).__name__} has no output '{name}'")

    def has_input(self, name: str) -> bool:
        return any(e.name == name for e in self.INPUTS)

    def has_output(self, name: str) -> bool:
        return any(e.name == name for e in self.OUTPUTS)

    @property
    def event_inputs(self) -> List[Endpoint]:
        return [e for e in self.INPUTS if e.kind == Kind.EVENT]

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def init_state(self, sr: SampleRate) -> State:
        """Build the node's state pytree (the ``prepare()`` analogue)."""
        return {}

    def tick(self, state: State, ins: Values, sr: SampleRate
             ) -> Tuple[State, Values]:
        """Advance one sample.  ``ins`` maps input endpoint names to values;
        returns (new_state, {output endpoint -> value})."""
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # events
    # ------------------------------------------------------------------ #
    def apply_event(self, state: State, endpoint: str, value,
                    sr: SampleRate, ins: Values) -> State:
        """Invoke the ``on_<endpoint>`` handler (unmasked).

        ``ins`` carries this sample's already-assigned input values — the
        analogue of the reference's edge assignments running before
        ``process_event_inputs`` (emit_node.rs:181-362 ordering).
        """
        handler = getattr(self, f"on_{endpoint}", None)
        if handler is None:
            return state
        return handler(state, value, sr, ins)

    def apply_events_at(self, state: State, endpoint: str,
                        buf: EventBuffer, t, sr: SampleRate,
                        ins: Values) -> State:
        """Apply every event in ``buf`` whose offset == t, in order, each
        under a mask.  Reproduces the reference's process_event_inputs
        dispatch (oscen-macros lib.rs:266-295) inside traced code."""
        handler = getattr(self, f"on_{endpoint}", None)
        if handler is None or buf.capacity == 0:
            return state
        for k in range(buf.capacity):
            fire = jnp.logical_and(buf.valid[..., k], buf.offsets[..., k] == t)
            new_state = handler(state, buf.values[..., k], sr, ins)
            state = _select_tree(fire, new_state, state)
        return state

    # ------------------------------------------------------------------ #
    # block-mode
    # ------------------------------------------------------------------ #
    def process_block(self, state: State, ins: Values,
                      events: Dict[str, EventBuffer], sr: SampleRate,
                      block_len: int) -> Tuple[State, Values]:
        """Vectorized block implementation.  ``ins`` values carry a leading
        time axis ``[B, ...]``.  Default: ``lax.scan`` over :meth:`tick`
        with masked event application — always correct, not always fast.
        Subclasses override with cumsum/scan/closed-form math."""
        return scan_tick_block(self, state, ins, events, sr, block_len)

    # ------------------------------------------------------------------ #
    def default_inputs(self) -> Values:
        out = {}
        for e in self.INPUTS:
            if e.kind in (Kind.STREAM, Kind.VALUE):
                d = e.default
                if e.shape or e.channels > 1:
                    shape = e.shape if e.shape else (e.channels,)
                    out[e.name] = jnp.full(shape, d, jnp.float32)
                else:
                    out[e.name] = jnp.float32(d)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}()"


class StepValue:
    """A host-node value output that is a single step function over the
    block: ``base`` before ``offset``, ``target`` from ``offset`` on.

    Staging protocol (compile.py ``_host_prepass``): when every instance
    of a host-node endpoint returns a StepValue or a block-constant [1]
    array, the endpoint stages as a tiny ``(3[, C])`` base/target/offset
    tensor reconstructed to ``[B(, C)]`` ON DEVICE at block-fn entry
    (block_mode ``reconstruct_step_values``) — instead of a host-built
    ``[B, C]`` array.  At 256 voices and B=1024 the host-built array is
    ~1 MB per block over the host↔device link, in every block of a
    MIDI-every-block workload.  The reference pays no such cost
    because control and audio share memory (main.rs:197-209); this is
    the host↔device redesign of the same per-callback event handling.
    """

    __slots__ = ("base", "offset", "target")

    def __init__(self, base: float, offset: int, target: float):
        self.base = float(base)
        self.offset = int(offset)
        self.target = float(target)

    def materialize(self, block_len: int) -> np.ndarray:
        """The equivalent host-built [B] step array (fallback path and
        parity tests)."""
        arr = np.full((block_len,), np.float32(self.base), np.float32)
        arr[min(self.offset, block_len - 1):] = np.float32(self.target)
        return arr

    def __repr__(self) -> str:  # pragma: no cover
        return (f"StepValue({self.base!r}, {self.offset!r}, "
                f"{self.target!r})")


class HostNode(Node):
    """Control-rate node evaluated on the host once per block.

    The analogue of the reference's event-phase nodes (MidiParser,
    VoiceAllocator, MidiVoiceHandler, EventPassthrough): pure control logic
    at event rate, never touching per-sample streams.  Host nodes keep
    mutable Python state (like the reference's struct fields) and translate
    event lists to event lists / per-sample value arrays the device consumes.
    """

    HOST = True

    # Event-driven contract: outputs change only in response to input
    # events / value changes — absent both, a block's outputs reproduce
    # verbatim.  CompiledGraph uses this to cache steady-state staging
    # (one jit call per idle block).  Set False on a host node whose
    # outputs vary with time regardless of inputs.
    HOST_STEADY = True

    def host_process(self, block_len: int,
                     events_in: Dict[str, List[EventInstance]],
                     values_in: Dict[str, float],
                     ) -> Tuple[Dict[str, List[EventInstance]],
                                Dict[str, np.ndarray]]:
        """Process one block of control data.

        Returns (event outputs by endpoint, value outputs by endpoint —
        per-sample ``[B]`` float32 arrays, block-constant ``[1]`` arrays,
        or :class:`StepValue`).  ``events_in`` sequences are read-only
        (they may be shared tuples).  An event endpoint omitted from the
        returned dict emits nothing this block (the prepass clears its
        persistent slot); an omitted VALUE endpoint keeps its previous
        value ("unchanged") — see compile.py's ``_host_steady``
        bookkeeping.
        """
        raise NotImplementedError

    def reset(self) -> None:
        """Return host state to its initial condition."""

    def host_state(self):
        """Snapshot this node's mutable control state (for checkpointing —
        utils/checkpoint.py).  Default: a deep copy of the instance dict,
        which covers plain-Python control state (LRU voice tables, current
        note/frequency, counters)."""
        import copy
        return copy.deepcopy(self.__dict__)

    def restore_host_state(self, snapshot) -> None:
        """Restore a snapshot taken by :meth:`host_state`.

        Endpoint declarations (INPUTS/OUTPUTS) are structural config, not
        runtime state — restoring them from an older build could corrupt
        a live node, so they are excluded from the update."""
        import copy
        snap = {k: v for k, v in snapshot.items()
                if k not in ("INPUTS", "OUTPUTS")}
        self.__dict__.update(copy.deepcopy(snap))

    def tick(self, state, ins, sr):  # pragma: no cover
        raise TypeError(f"{type(self).__name__} is a host-domain node")


# ---------------------------------------------------------------------- #
# helpers
# ---------------------------------------------------------------------- #
def _select_tree(pred, on_true, on_false):
    """Elementwise tree select; ``pred`` may broadcast against leaves."""
    def sel(a, b):
        a = jnp.asarray(a)
        b = jnp.asarray(b)
        p = pred
        extra = max(a.ndim, b.ndim) - jnp.ndim(p)
        if extra > 0:
            p = jnp.reshape(p, jnp.shape(p) + (1,) * extra)
        return jnp.where(p, a, b)
    return jax.tree_util.tree_map(sel, on_true, on_false)


def scan_tick_block(node: Node, state: State, ins: Values,
                    events: Dict[str, EventBuffer], sr: SampleRate,
                    block_len: int) -> Tuple[State, Values]:
    """Default block implementation: scan the per-sample tick over time."""
    ev_names = sorted(events.keys())

    def body(carry, xs):
        st = carry
        t, per_t = xs
        for name in ev_names:
            st = node.apply_events_at(st, name, events[name], t, sr, per_t)
        st, outs = node.tick(st, per_t, sr)
        return st, outs

    ts = jnp.arange(block_len, dtype=jnp.int32)
    state, outs = jax.lax.scan(body, state, (ts, ins))
    return state, outs


def select_tree(pred, on_true, on_false):
    return _select_tree(pred, on_true, on_false)
