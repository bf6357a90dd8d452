"""Graph compiler: IR → traced, jitted block function.

The reference emits Rust source whose ``process_block`` advances every node
one sample in topological order (codegen/mod.rs:539, emit_frame.rs).  Here
"codegen" builds a *traced function* over explicit state pytrees:

- **sample mode** — the whole graph is fused into one ``lax.scan`` whose body
  replays the reference's per-sample schedule exactly (edge assignments →
  event dispatch → node tick, in topo order).  Op-order parity with the Rust
  build; fully vectorized across node-array instances (voices).
- **block mode** — each node's time-vectorized ``process_block`` runs over
  whole ``[B]`` blocks in topo order (cumsum phases, associative scans,
  closed forms).  Nodes caught in feedback-carrying regions fall back to a
  per-sample scan island.

The host↔device split mirrors the reference's control-thread↔audio-thread
boundary: host-domain nodes (MIDI parsing, voice allocation) run in Python
per block and stage dense per-sample arrays + static event buffers into the
jitted step — the mpsc/handoff analogue (SURVEY §5.8).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.events import EventBuffer, EventInstance, scalar_event
from ..core.ramp import ValueRampState
from ..core.types import (DEFAULT_MAX_BLOCK_SIZE,
                          MAX_STATIC_EVENTS_PER_ENDPOINT, Kind, SampleRate)
from .ir import (BinOp, Call, Const, EdgeKernel, EndpointRef, Expr, Fanout,
                 FrameCtor, IrEdge, IrGraph, IrNodeInst)
from .node import HostNode, Node, StepValue

__all__ = ["CompiledGraph"]


class _StepStack:
    """Marker wrapper for a (3, C) base/target/offset step-staging array
    built in ``_host_prepass`` (see graph/node.py StepValue)."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data


def _step_staging_on() -> bool:
    import os
    return os.environ.get("OSCEN_STEP_STAGING", "1") != "0"


def _packed_staging_on() -> bool:
    import os
    return os.environ.get("OSCEN_PACKED_STAGING", "1") != "0"


# shared immutable empty event sequence (host_process inputs are
# read-only by contract; a tuple makes accidental mutation an error)
_EMPTY_EVS: tuple = ()


def _round_capacity(n: int) -> int:
    """Pad event-buffer capacity to limit jit re-specialization."""
    if n == 0:
        return 0
    c = 1
    while c < n:
        c *= 2
    return c


# ===================================================================== #
# Program: static schedule extracted from the IR
# ===================================================================== #
class _Program:
    def __init__(self, ir: IrGraph, sample_rate: float,
                 block_size: Optional[int] = None):
        self.ir = ir
        self.sr = SampleRate(float(sample_rate))
        self.block_size = block_size
        self.host_nodes: List[str] = [
            n for n in ir.order if ir.nodes[n].node.HOST]
        self.device_nodes: List[str] = [
            n for n in ir.order if not ir.nodes[n].node.HOST]
        self.host_set = set(self.host_nodes)

        self.multirate = any(ir.nodes[n].rate != 1 for n in ir.order)

        # resampler kernels per cross-rate edge (reference dispatch tables:
        # stream Default -> sinc FIR, value Default -> latch)
        from ..core.types import Policy
        from ..ops import resample as _rs
        self.resamplers: Dict[int, Any] = {}
        self.edge_ids: Dict[int, int] = {}
        for idx, e in enumerate(ir.edges):
            self.edge_ids[id(e)] = idx
            if e.kernel not in (EdgeKernel.UP, EdgeKernel.DOWN):
                continue
            if e.policy == Policy.DEFAULT:
                pol = "latch" if e.kind == Kind.VALUE else "sinc"
            else:
                pol = e.policy.value
            if e.kernel == EdgeKernel.UP:
                self.resamplers[idx] = _rs.make_upsampler(pol, e.rate_factor)
            else:
                self.resamplers[idx] = _rs.make_downsampler(
                    pol, e.rate_factor)

        # edges grouped by destination (declaration order preserved)
        self.edges_by_dst: Dict[Tuple[str, str], List[IrEdge]] = {}
        for e in ir.edges:
            self.edges_by_dst.setdefault(
                (e.dst_node, e.dst_endpoint), []).append(e)

        # feedback carries: endpoints read from the previous sample
        self.fb_keys: List[Tuple[str, str]] = []
        for e in ir.edges:
            if e.is_feedback and e.src_reads_state:
                for r in e.source.endpoints():
                    if r.node and (r.node, r.endpoint) not in self.fb_keys:
                        self.fb_keys.append((r.node, r.endpoint))

        # device event endpoints (consume staged EventBuffers)
        self.event_endpoints: List[Tuple[str, str]] = []
        for name in self.device_nodes:
            inst = ir.nodes[name]
            for ep in inst.node.INPUTS:
                if ep.kind == Kind.EVENT:
                    self.event_endpoints.append((name, ep.name))

        # host node arrays get independent per-instance control state
        import copy as _copy
        self.host_instances: Dict[str, list] = {}
        for name in self.host_nodes:
            inst = ir.nodes[name]
            if inst.count > 1:
                self.host_instances[name] = [
                    _copy.deepcopy(inst.node) for _ in range(inst.count)]

        self._validate_host_placement()

    def _validate_host_placement(self):
        for e in self.ir.edges:
            if e.dst_node in self.host_set:
                for r in e.source.endpoints():
                    if r.node and r.node not in self.host_set:
                        raise ValueError(
                            f"device node '{r.node}' cannot feed host-domain "
                            f"node '{e.dst_node}' (host nodes are control-"
                            f"rate, like the reference's event phase)")

    # ----------------------------------------------------------------- #
    def init_device_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {}
        for name in self.device_nodes:
            inst = self.ir.nodes[name]
            s = inst.node.init_state(self.scaled_sr(inst))
            # block-size-dependent extensions (e.g. the Convolver's FDL
            # spectra/partition state); only exist when a block size is set
            init_blk = getattr(inst.node, "init_block_state", None)
            if init_blk is not None and self.block_size:
                s = {**s, **init_blk(self.scaled_sr(inst),
                                     int(self.block_size))}
            if inst.count > 1:
                s = jax.tree_util.tree_map(
                    lambda x: jnp.broadcast_to(
                        jnp.asarray(x), (inst.count,) + jnp.shape(
                            jnp.asarray(x))).copy(), s)
            state[name] = s
        fb = {}
        for (n, ep) in self.fb_keys:
            inst = self.ir.nodes[n]
            decl = inst.node.output(ep)
            shape = decl.shape if decl.shape else (
                () if decl.channels == 1 else (decl.channels,))
            if inst.count > 1:
                shape = (inst.count,) + shape
            fb[f"{n}.{ep}"] = jnp.zeros(shape, jnp.float32)
        state["__fb__"] = fb

        rs = {}
        for idx, kern in self.resamplers.items():
            e = self.ir.edges[idx]
            payload = self._edge_payload_shape(e)
            like = jnp.zeros((1,) + payload, jnp.float32)
            rs[str(idx)] = kern.init_state(like)
        state["__rs__"] = rs
        return state

    def _edge_payload_shape(self, e: IrEdge) -> tuple:
        """Trailing (non-time) shape carried by a cross-rate edge: channel
        axes plus a trailing instance axis for node arrays (resamplers
        broadcast over trailing dims)."""
        inst = self.ir.nodes[e.dst_node]
        ep = inst.node.input(e.dst_endpoint)
        payload = ep.shape if ep.shape else (
            () if ep.channels == 1 else (ep.channels,))
        if inst.count > 1 and e.dst_index is None:
            payload = payload + (inst.count,)
        return payload

    def scaled_sr(self, inst: IrNodeInst) -> SampleRate:
        return SampleRate(self.sr.hz * inst.rate)

    # ----------------------------------------------------------------- #
    # expression evaluation
    # ----------------------------------------------------------------- #
    def eval_expr(self, expr: Expr, resolve) -> Any:
        """Evaluate a connection expression; ``resolve(ref)`` supplies
        endpoint values."""
        if isinstance(expr, Const):
            return jnp.float32(expr.value)
        if isinstance(expr, EndpointRef):
            v = resolve(expr)
            if expr.index is not None:
                v = v[expr.index]
            if expr.channel is not None:
                v = v[..., expr.channel]
            return v
        if isinstance(expr, BinOp):
            a = self.eval_expr(expr.lhs, resolve)
            b = self.eval_expr(expr.rhs, resolve)
            return {"+": lambda: a + b, "-": lambda: a - b,
                    "*": lambda: a * b, "/": lambda: a / b}[expr.op]()
        if isinstance(expr, Call):
            args = [self.eval_expr(a, resolve) for a in expr.args]
            return expr.fn(*args)
        if isinstance(expr, FrameCtor):
            chans = [self.eval_expr(c, resolve) for c in expr.channels]
            return jnp.stack([jnp.broadcast_to(
                c, jnp.broadcast_shapes(*[jnp.shape(x) for x in chans]))
                for c in chans], axis=-1)
        raise TypeError(f"bad expression {expr!r}")

    def gather_inputs(self, name: str, resolve_for_edge,
                      override=None) -> Dict[str, Any]:
        """Evaluate all edges into ``name`` (connect + accumulate fan-in,
        static_context.rs:160-217), fill unconnected inputs with defaults,
        broadcast for node arrays.  ``override(edge)`` may supply an
        already-destination-shaped value (cross-rate edges in the
        multirate schedule)."""
        inst = self.ir.nodes[name]
        node = inst.node
        ins: Dict[str, Any] = {}
        for ep in node.INPUTS:
            if ep.kind in (Kind.EVENT, Kind.ASSET):
                continue
            edges = self.edges_by_dst.get((name, ep.name), [])
            val = None
            for e in edges:
                ov = override(e) if override is not None else None
                if ov is not None:
                    v = ov
                else:
                    v = self.eval_expr(e.source, resolve_for_edge(e))
                    if e.fanout == Fanout.FAN_IN and e.dst_index is None:
                        v = jnp.sum(v, axis=0)
                    if e.dst_index is None:
                        if e.fanout == Fanout.BROADCAST or (
                                inst.count > 1
                                and e.fanout == Fanout.SCALAR):
                            v = self._broadcast_to_count(v, inst.count, ep)
                        elif e.fanout == Fanout.PARALLEL:
                            v = self._truncate_parallel(v, inst.count)
                        elif e.fanout == Fanout.REPEAT:
                            v = jnp.repeat(jnp.asarray(v), e.factor,
                                           axis=0)
                        elif e.fanout == Fanout.SEGMENT_SUM:
                            v = self._segment_sum(v, e.factor)
                if e.dst_index is not None:
                    base = val
                    if base is None:
                        base = self._default_value(inst, ep)
                    val = base.at[e.dst_index].set(v) \
                        if hasattr(base, "at") else base
                elif val is None:
                    val = v
                else:
                    val = val + v  # accumulate (stream fan-in sum)
            if val is None:
                val = self._default_value(inst, ep)
            ins[ep.name] = val
        return ins

    def normalize_for_dst(self, e: IrEdge, v):
        """Apply fanout transforms producing the destination's per-sample
        shape (count?, *payload)."""
        inst = self.ir.nodes[e.dst_node]
        ep = inst.node.input(e.dst_endpoint)
        if e.fanout == Fanout.FAN_IN and e.dst_index is None:
            v = jnp.sum(v, axis=0)
        if e.dst_index is None and inst.count > 1:
            if e.fanout in (Fanout.BROADCAST, Fanout.SCALAR, Fanout.FAN_IN):
                v = self._broadcast_to_count(v, inst.count, ep)
            elif e.fanout == Fanout.PARALLEL:
                v = self._truncate_parallel(v, inst.count)
            elif e.fanout == Fanout.REPEAT:
                v = jnp.repeat(jnp.asarray(v), e.factor, axis=0)
            elif e.fanout == Fanout.SEGMENT_SUM:
                v = self._segment_sum(v, e.factor)
        return v

    def _default_value(self, inst: IrNodeInst, ep) -> Any:
        shape = ep.shape if ep.shape else (
            () if ep.channels == 1 else (ep.channels,))
        if inst.count > 1:
            shape = (inst.count,) + shape
        return jnp.full(shape, float(ep.default or 0.0), jnp.float32)

    def _broadcast_to_count(self, v, count: int, ep) -> Any:
        v = jnp.asarray(v)
        return jnp.broadcast_to(v, (count,) + v.shape)

    def _truncate_parallel(self, v, count: int) -> Any:
        # min-truncation on count mismatch (ir/graph.rs:48-78)
        return v[:count] if v.shape[0] != count else v

    @staticmethod
    def _segment_sum(v, factor: int) -> Any:
        """Per-outer-instance fan-in for arrays flattened out of array
        subgraphs: (g*m, ...) -> (g, ...) summing each m-segment."""
        v = jnp.asarray(v)
        return jnp.reshape(
            v, (v.shape[0] // factor, factor) + v.shape[1:]).sum(axis=1)


# ===================================================================== #
# Sample-mode step
# ===================================================================== #
class _SampleStep:
    """Per-sample fused body — the ``__advance_one_frame`` analogue
    (emit_frame.rs:29-108 same-rate, :95-108 + :114-176 multirate),
    traced once and scanned over the block."""

    def __init__(self, prog: _Program):
        self.prog = prog
        ir = prog.ir
        self.inner_nodes = [n for n in prog.device_nodes
                            if ir.nodes[n].rate != 1]
        rates = {ir.nodes[n].rate for n in self.inner_nodes}
        if len(rates) > 1:
            raise ValueError(
                "mixed oversampling factors in one graph are unsupported "
                "(the reference rejects mixed inner rates, "
                "lower.rs:797-809)")
        self.inner_rate = rates.pop() if rates else 1
        self.up_edges = [e for e in ir.edges
                         if e.kernel == EdgeKernel.UP]
        self.down_edges = [e for e in ir.edges
                           if e.kernel == EdgeKernel.DOWN]
        # taint: outer consumers (transitive) of Down-edge outputs run
        # after the inner loop (emit_node.rs:516-584)
        tainted = {e.dst_node for e in self.down_edges}
        changed = True
        while changed:
            changed = False
            for e in ir.edges:
                if e.is_feedback or e.dst_node in tainted:
                    continue
                srcs = {r.node for r in e.source.endpoints() if r.node}
                if srcs & tainted:
                    tainted.add(e.dst_node)
                    changed = True
        for e in self.up_edges:
            srcs = {r.node for r in e.source.endpoints() if r.node}
            if srcs & tainted:
                raise ValueError(
                    "down-then-up diamond (an oversampled region fed from "
                    "a downsampled signal) is rejected, as in the "
                    "reference (emit_node.rs:516-584)")
        outer = [n for n in prog.device_nodes
                 if ir.nodes[n].rate == 1]
        self.pre_nodes = [n for n in outer if n not in tainted]
        self.post_nodes = [n for n in outer if n in tainted]

    # ------------------------------------------------------------------ #
    def _run_node(self, new_state, env, name, t_ev, ev_bufs, resolver,
                  override=None):
        prog = self.prog
        inst = prog.ir.nodes[name]
        node = inst.node
        sr = prog.scaled_sr(inst)
        ins = prog.gather_inputs(name, resolver, override)
        st = new_state[name]
        for ep in node.INPUTS:
            if ep.kind != Kind.EVENT:
                continue
            buf = ev_bufs.get(f"{name}.{ep.name}")
            if buf is None or buf.capacity == 0:
                continue
            if inst.count > 1:
                st = jax.vmap(
                    lambda s, b, i: node.apply_events_at(
                        s, ep.name, b, t_ev, sr, i)
                )(st, buf, ins)
            else:
                st = node.apply_events_at(st, ep.name, buf, t_ev, sr, ins)
        if inst.count > 1:
            st, outs = jax.vmap(
                lambda s, i: node.tick(s, i, sr))(st, ins)
        else:
            st, outs = node.tick(st, ins, sr)
        new_state[name] = st
        for k, v in outs.items():
            env[(name, k)] = v

    # ------------------------------------------------------------------ #
    def __call__(self, state: Dict[str, Any], t, per_sample: Dict[str, Any],
                 ev_bufs: Dict[str, EventBuffer]
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        prog = self.prog
        ir = prog.ir
        env: Dict[Tuple[str, str], Any] = {}

        def resolver(edge: Optional[IrEdge]):
            def resolve(ref: EndpointRef):
                if ref.node == "":
                    return per_sample[ref.endpoint]
                if ref.node in prog.host_set:
                    return per_sample[f"__host__{ref.node}.{ref.endpoint}"]
                key = (ref.node, ref.endpoint)
                if edge is not None and edge.is_feedback \
                        and edge.src_reads_state and key not in env:
                    return state["__fb__"][f"{ref.node}.{ref.endpoint}"]
                if key in env:
                    return env[key]
                # source not yet computed: previous-sample read
                return state["__fb__"][f"{ref.node}.{ref.endpoint}"]
            return resolve

        new_state = dict(state)

        if not self.inner_nodes:
            for name in prog.device_nodes:
                self._run_node(new_state, env, name, t, ev_bufs, resolver)
        else:
            # ---- multirate schedule (emit_frame.rs:114-176) ----------
            N = self.inner_rate
            rs = dict(new_state["__rs__"])

            for name in self.pre_nodes:
                self._run_node(new_state, env, name, t, ev_bufs, resolver)

            # up-warmup: one outer value in, N inner values out per edge
            up_vals: Dict[int, Any] = {}
            for e in self.up_edges:
                idx = prog.edge_ids[id(e)]
                v = prog.eval_expr(e.source, resolver(e))
                v = prog.normalize_for_dst(e, v)
                count = (prog.ir.nodes[e.dst_node].count
                         if e.dst_index is None else 1)
                if count > 1:
                    v = jnp.moveaxis(jnp.asarray(v), 0, -1)
                st, buf = prog.resamplers[idx].process_block(
                    rs[str(idx)], jnp.asarray(v)[None])
                rs[str(idx)] = st
                if count > 1:
                    buf = jnp.moveaxis(buf, -1, 1)  # [N, C, *payload]
                up_vals[idx] = buf

            # inner loop ×N
            down_collect: Dict[int, list] = {
                prog.edge_ids[id(e)]: [] for e in self.down_edges}
            for i in range(N):
                def override_up(e, i=i):
                    if e.kernel == EdgeKernel.UP:
                        return up_vals[prog.edge_ids[id(e)]][i]
                    return None
                t_inner = t * N + i
                for name in self.inner_nodes:
                    self._run_node(new_state, env, name, t_inner, ev_bufs,
                                   resolver, override_up)
                for e in self.down_edges:
                    v = prog.eval_expr(e.source, resolver(e))
                    v = prog.normalize_for_dst(e, v)
                    down_collect[prog.edge_ids[id(e)]].append(v)

            # down-finalize
            down_vals: Dict[int, Any] = {}
            for e in self.down_edges:
                idx = prog.edge_ids[id(e)]
                count = (prog.ir.nodes[e.dst_node].count
                         if e.dst_index is None else 1)
                stacked = jnp.stack(
                    [jnp.asarray(v) for v in down_collect[idx]], axis=0)
                if count > 1:
                    stacked = jnp.moveaxis(stacked, 1, -1)
                st, y = prog.resamplers[idx].process_block(
                    rs[str(idx)], stacked)
                rs[str(idx)] = st
                y = y[0]
                if count > 1:
                    y = jnp.moveaxis(y, -1, 0)
                down_vals[idx] = y

            def override_down(e):
                if e.kernel == EdgeKernel.DOWN:
                    return down_vals[prog.edge_ids[id(e)]]
                return None

            for name in self.post_nodes:
                self._run_node(new_state, env, name, t, ev_bufs, resolver,
                               override_down)
            new_state["__rs__"] = rs

        # refresh feedback carries with this sample's outputs
        fb = dict(state["__fb__"])
        for (n, ep) in prog.fb_keys:
            fb[f"{n}.{ep}"] = env[(n, ep)]
        new_state["__fb__"] = fb

        outs = {}
        for o_ in ir.outputs:
            if o_.kind == Kind.EVENT:
                continue  # event outputs are routed host-side
            expr = ir.output_edges.get(o_.name)
            if expr is None:
                continue
            v = prog.eval_expr(expr, resolver(None))
            # FanIn at the graph output: array-sourced outputs mix down by
            # summation (emit_edge.rs:67-84; sum lowers to psum when the
            # voice axis is sharded over a mesh)
            want = 0 if o_.channels == 1 else 1
            while jnp.ndim(v) > want:
                v = jnp.sum(v, axis=0)
            outs[o_.name] = v
        for o in ir.outputs:
            if o.kind != Kind.EVENT and o.name not in outs:
                shape = () if o.channels == 1 else (o.channels,)
                outs[o.name] = jnp.zeros(shape, jnp.float32)
        return new_state, outs


# ===================================================================== #
# CompiledGraph — stateful host wrapper
# ===================================================================== #
class CompiledGraph:
    """Runtime handle: host param/event staging + the jitted device step.

    The analogue of a generated graph struct: ``init``, per-input setters
    (``set_value`` / ``set_value_ramped`` / ``queue_event``), and
    ``process_block`` (sample-accurate events, ramps, RT-safe in the sense
    that steady-state blocks never retrace or sync).
    """

    def __init__(self, ir: IrGraph, sample_rate: float = 44100.0,
                 block_size: int = DEFAULT_MAX_BLOCK_SIZE,
                 mode: str = "sample", jit: bool = True):
        if mode not in ("sample", "block"):
            raise ValueError(f"unknown mode {mode!r}")
        self.ir = ir
        self.mode = mode
        self.block_size = int(block_size)
        self.sample_rate = float(sample_rate)
        self._jit = jit
        self.prog = _Program(ir, sample_rate,
                             block_size if mode == "block" else None)
        self._step = _SampleStep(self.prog)

        # host parameter state
        self._params: Dict[str, ValueRampState] = {}
        self._event_queues: Dict[str, List[EventInstance]] = {}
        for gi in ir.inputs:
            if gi.kind == Kind.VALUE:
                self._params[gi.name] = ValueRampState(float(gi.default))
            elif gi.kind == Kind.EVENT:
                self._event_queues[gi.name] = []
        self._stream_in_names = [i.name for i in ir.inputs
                                 if i.kind == Kind.STREAM]

        self.state = self.prog.init_device_state()
        self._block_fn_cache: Dict[Any, Any] = {}
        # steady-state staging cache: when the control plane is idle (no
        # pending events, no param changes, no active ramps) the host
        # prepass and per-block staging are reproducible block-to-block —
        # reuse them so a steady block is ONE cached jit call (the
        # per-block Python staging otherwise bounds streaming throughput)
        self._staging_cache: Dict[int, Any] = {}
        # per-host-node-array persistent steady outputs (see
        # _host_prepass): name -> {B, v_in, ev/val per-instance lists,
        # stale instance set}
        self._host_steady: Dict[str, Any] = {}
        # device-resident zero blocks for unconnected stream inputs
        self._zeros_cache: Dict[Tuple, Any] = {}
        self._control_dirty = True

    # ------------------------------------------------------------------ #
    def init(self, sample_rate: Optional[float] = None) -> None:
        """Re-prepare: rebuild all node state at the given rate."""
        if sample_rate is not None and sample_rate != self.sample_rate:
            self.sample_rate = float(sample_rate)
            self.prog = _Program(
                self.ir, self.sample_rate,
                self.block_size if self.mode == "block" else None)
            self._step = _SampleStep(self.prog)
            self._block_fn_cache.clear()
        self.state = self.prog.init_device_state()
        self._control_dirty = True
        self._staging_cache.clear()
        self._host_steady.clear()
        for name in self.prog.host_nodes:
            self.ir.nodes[name].node.reset()
            for n in self.prog.host_instances.get(name, []):
                n.reset()
        for q in self._event_queues.values():
            q.clear()

    # ------------------------------------------------------------------ #
    # setters (generated set_x / set_x_with_ramp analogues)
    # ------------------------------------------------------------------ #
    def set_value(self, name: str, v: float) -> None:
        spec = self.ir.get_input(name).spec
        frames = spec.ramp_frames if spec else 0
        self._control_dirty = True
        if frames:
            self._params[name].set_with_ramp(v, frames)
        else:
            self._params[name].set_immediate(v)

    def set_value_immediate(self, name: str, v: float) -> None:
        self._control_dirty = True
        self._params[name].set_immediate(v)

    def set_value_with_ramp(self, name: str, v: float, frames: int) -> None:
        self._control_dirty = True
        self._params[name].set_with_ramp(v, frames)

    def queue_event(self, name: str, frame_offset: int, payload) -> None:
        if name not in self._event_queues:
            raise KeyError(f"'{name}' is not an event input")
        self._control_dirty = True
        self._event_queues[name].append(
            EventInstance(int(frame_offset), payload))

    # ------------------------------------------------------------------ #
    # assets (publish -> take -> retire analogue; reference asset/mod.rs)
    # ------------------------------------------------------------------ #
    def publish_asset(self, external: str, a) -> None:
        """Conform an AudioAsset to the graph rate and swap it into every
        bound node's state between blocks (the control-thread publish;
        the render path sees a pure functional state replacement with
        unchanged shapes — no retrace)."""
        from ..assets import AssetError, AudioAsset

        bindings = [b for b in self.ir.asset_bindings if b[0] == external]
        if not bindings:
            raise KeyError(f"unknown external asset '{external}'")
        self._control_dirty = True
        if not isinstance(a, AudioAsset):
            raise AssetError("publish_asset expects an AudioAsset")
        if a.sample_rate != int(self.sample_rate):
            a = AudioAsset.from_samples(a.channels_data, a.sample_rate,
                                        graph_rate=self.sample_rate)
        for (_, node_name, endpoint) in bindings:
            inst = self.ir.nodes[node_name]
            node = inst.node
            consume = getattr(node, "asset_consume", None)
            if consume is None:
                raise AssetError(
                    f"node '{node_name}' has no asset consumer")
            sr = self.prog.scaled_sr(inst)
            if inst.count > 1:
                # one published asset broadcast into every instance's
                # state slot (reference asset wiring is generic over
                # nodes, asset/mod.rs:309-320 / emit_struct.rs:434-464):
                # consume once, then broadcast the asset-derived leaves
                # across the instance axis; per-instance leaves that the
                # consumer left untouched keep their per-voice values.
                st = self.state[node_name]
                first = jax.tree_util.tree_map(lambda x: x[0], st)
                new_first = consume(first, a, sr)
                cnt = inst.count

                def merge(old_stacked, old_first, new_leaf):
                    if new_leaf is old_first:   # untouched by consume
                        return old_stacked
                    return jnp.broadcast_to(
                        jnp.asarray(new_leaf)[None],
                        (cnt,) + jnp.shape(new_leaf))
                self.state[node_name] = jax.tree_util.tree_map(
                    merge, st, first, new_first)
            else:
                self.state[node_name] = consume(
                    self.state[node_name], a, sr)

    def load_wav(self, external: str, path: str) -> None:
        """Decode + conform + publish (reference AssetLoadHandle::load_wav,
        asset/mod.rs:290-294)."""
        from ..assets import AudioAsset
        self.publish_asset(
            external, AudioAsset.from_wav(path, graph_rate=self.sample_rate))

    # ------------------------------------------------------------------ #
    # host pre-pass
    # ------------------------------------------------------------------ #
    def _host_prepass(self, block_len: int
                      ) -> Tuple[Dict[str, EventBuffer],
                                 Dict[str, np.ndarray]]:
        """Run host-domain control nodes; stage device event buffers and
        host-produced per-sample value arrays."""
        prog = self.prog
        ir = self.ir
        # event environment: (node, endpoint) -> event list (or list of
        # lists for array outputs); graph inputs live under node ""
        ev_env: Dict[Tuple[str, str], Any] = {}
        val_env: Dict[Tuple[str, str], np.ndarray] = {}
        for name, q in self._event_queues.items():
            ev_env[("", name)] = list(q)
            q.clear()

        def source_events(e: IrEdge):
            src = e.source
            if not isinstance(src, EndpointRef):
                raise ValueError("event edges must be bare endpoints")
            return ev_env.get((src.node, src.endpoint), [])

        def host_value_in(edges, ep):
            v = float(ep.default or 0.0)
            for e in edges:
                src = e.source
                if isinstance(src, Const):
                    v = src.value
                elif isinstance(src, EndpointRef) and src.node == "":
                    v = float(self._params[src.endpoint].current)
            return v

        for name in prog.host_nodes:
            inst = ir.nodes[name]
            if inst.count == 1:
                node = inst.node
                ev_in: Dict[str, list] = {}
                v_in: Dict[str, Any] = {}
                for ep in node.INPUTS:
                    edges = prog.edges_by_dst.get((name, ep.name), [])
                    if ep.kind == Kind.EVENT:
                        # event fan-in is last-write-wins per block: each
                        # edge's copy REPLACES the queue (reference
                        # AccumulateEndpoints delegates events to connect,
                        # static_context.rs:160-217)
                        evs: List[EventInstance] = []
                        for e in edges:
                            src_evs = source_events(e)
                            if src_evs and isinstance(src_evs[0], list):
                                idx = e.source.index
                                if idx is not None:
                                    evs = list(src_evs[idx])
                                else:
                                    evs = [x for sub in src_evs
                                           for x in sub]
                            else:
                                evs = list(src_evs)
                        ev_in[ep.name] = sorted(
                            evs, key=lambda x: x.frame_offset)
                    else:
                        v_in[ep.name] = host_value_in(edges, ep)
                evs_out, vals_out = node.host_process(block_len, ev_in, v_in)
                for ep, evs in (evs_out or {}).items():
                    ev_env[(name, ep)] = evs
                for ep, arr in (vals_out or {}).items():
                    val_env[(name, ep)] = (
                        arr if isinstance(arr, StepValue)
                        else np.asarray(arr, np.float32))
            else:
                # host node array: per-instance control state, parallel
                # event demux from array sources (broadcast scalar
                # sources).  The input resolution is done ONCE per
                # endpoint (not per instance): value inputs are
                # instance-independent (graph params / consts) and event
                # edges resolve to per-instance lists in one pass —
                # last-write-wins per edge in edge order, per instance
                # (connect semantics).  With N voices this makes the
                # prepass O(events) in real work instead of O(voices)
                # edge scans.
                instances = prog.host_instances[name]
                cnt = inst.count
                node0 = instances[0]
                v_in: Dict[str, Any] = {}
                ev_eps: List[str] = []
                per_inst_evs: Dict[str, List[list]] = {}
                for ep in node0.INPUTS:
                    edges = prog.edges_by_dst.get((name, ep.name), [])
                    if ep.kind != Kind.EVENT:
                        v_in[ep.name] = host_value_in(edges, ep)
                        continue
                    ev_eps.append(ep.name)
                    lists: List[list] = [_EMPTY_EVS] * cnt
                    for e in edges:
                        src_evs = source_events(e)
                        is_nested = bool(src_evs) and isinstance(
                            src_evs[0], list)
                        if e.dst_index is not None:
                            i = e.dst_index
                            if is_nested:
                                if e.source.index is not None:
                                    lists[i] = src_evs[e.source.index]
                                elif i < len(src_evs):
                                    lists[i] = src_evs[i]
                                else:
                                    lists[i] = _EMPTY_EVS
                            else:
                                lists[i] = src_evs
                        elif is_nested:
                            if e.source.index is not None:
                                sel = src_evs[e.source.index]
                                lists = [sel] * cnt
                            else:
                                lists = [
                                    src_evs[i] if i < len(src_evs)
                                    else _EMPTY_EVS for i in range(cnt)]
                        else:
                            lists = [src_evs] * cnt
                    per_inst_evs[ep.name] = lists
                active = set()
                for epn in ev_eps:
                    for i, evs in enumerate(per_inst_evs[epn]):
                        if evs:
                            active.add(i)
                empty_in = {epn: _EMPTY_EVS for epn in ev_eps}
                steady_cls = node0.HOST_STEADY
                # Persistent per-instance output lists: an event-driven
                # (HOST_STEADY) instance that received NO events and
                # whose value inputs are unchanged reproduces its
                # previous no-event outputs verbatim, so only instances
                # that are event-bearing THIS block, or were event-
                # bearing LAST block (their stored outputs describe that
                # block's offsets — stale), run host_process.  The
                # gathered per-endpoint lists persist and are poked in
                # place — the prepass does O(events) Python work, not
                # O(voices).
                hs = self._host_steady.get(name)
                if hs is None or not steady_cls or hs["B"] != block_len \
                        or hs["v_in"] != v_in:
                    hs = {"B": block_len, "v_in": dict(v_in),
                          "ev": {}, "val": {}, "vrec": {},
                          "stale": set(range(cnt))}
                    self._host_steady[name] = hs
                need = active | hs["stale"]
                for i in sorted(need):
                    node = instances[i]
                    if i in active:
                        ev_in = {
                            epn: sorted(per_inst_evs[epn][i],
                                        key=lambda x: x.frame_offset)
                            for epn in ev_eps}
                    else:
                        ev_in = dict(empty_in)
                    evs_out, vals_out = node.host_process(
                        block_len, ev_in, v_in)
                    evs_out = evs_out or {}
                    # defensive against partial returns: a node that
                    # omits an event endpoint this call emits NOTHING on
                    # it — clear the persistent slot or last block's
                    # events would re-stage forever (value endpoints, by
                    # contrast, persist as "unchanged")
                    for ep, lst in hs["ev"].items():
                        if ep not in evs_out:
                            lst[i] = _EMPTY_EVS
                    for ep, evs in evs_out.items():
                        hs["ev"].setdefault(ep, [_EMPTY_EVS] * cnt)[i] = evs
                    for ep, arr in (vals_out or {}).items():
                        # classify into the per-endpoint record so the
                        # staging below is O(changes): a scalar const
                        # updates the persistent const row, a StepValue
                        # joins the step set, anything else the full set
                        rec = hs["vrec"].get(ep)
                        if rec is None:
                            rec = {"const": np.zeros(cnt, np.float32),
                                   "steps": {}, "full": {}, "irr": set()}
                            hs["vrec"][ep] = rec
                        rec["steps"].pop(i, None)
                        rec["full"].pop(i, None)
                        rec["irr"].discard(i)
                        if isinstance(arr, StepValue):
                            rec["steps"][i] = arr
                            rec["const"][i] = arr.target
                        else:
                            arr = np.asarray(arr, np.float32)
                            if arr.ndim != 1:
                                # non-scalar payload: per-instance, and
                                # cleared when the instance reruns with a
                                # regular output (not sticky)
                                rec["irr"].add(i)
                                rec["full"][i] = arr
                            elif arr.shape[0] == 1:
                                rec["const"][i] = arr[0]
                            else:
                                rec["full"][i] = arr
                        hs["val"].setdefault(ep, [None] * cnt)[i] = arr
                hs["stale"] = set(active)
                for ep, evs in hs["ev"].items():
                    ev_env[(name, ep)] = evs  # list of per-instance lists
                for ep, rec in hs["vrec"].items():
                    # Step staging: when the only non-constant instances
                    # are single steps (one note-on), the endpoint stages
                    # as (3, C) base/target/offset rows — ~3 KB instead
                    # of the host-built [B, C] (~1 MB at 256 voices),
                    # reconstructed on device (block_mode
                    # reconstruct_step_values).  OSCEN_STEP_STAGING=0
                    # forces the materialized form (parity A/B).
                    steps = rec["steps"]
                    if rec["irr"] or rec["full"] or (
                            steps and not _step_staging_on()):
                        # generic fallback: materialize + broadcast +
                        # stack ([B, C]) — rare (multi-step blocks or
                        # non-scalar payloads)
                        arrs = [a.materialize(block_len)
                                if isinstance(a, StepValue) else a
                                for a in hs["val"][ep]]
                        L = max(a.shape[0] for a in arrs)
                        if any(a.shape[0] != L for a in arrs):
                            arrs = [np.broadcast_to(a, (L,) + a.shape[1:])
                                    for a in arrs]
                        val_env[(name, ep)] = np.stack(arrs, axis=-1)
                    elif steps:
                        base = rec["const"].copy()
                        tgt = rec["const"].copy()
                        off = np.full(cnt, float(block_len), np.float32)
                        for i, sv in steps.items():
                            base[i] = sv.base
                            tgt[i] = sv.target
                            off[i] = min(sv.offset, block_len - 1)
                        val_env[(name, ep)] = _StepStack(
                            np.stack([base, tgt, off]))
                    else:
                        # every instance block-constant: [1, C]
                        val_env[(name, ep)] = rec["const"].reshape(1, cnt)

        # stage device event buffers
        ev_bufs: Dict[str, EventBuffer] = {}
        for (name, ep) in prog.event_endpoints:
            inst = ir.nodes[name]

            def _scale(buf, rate=None):
                # outer->inner event frame-offset rescale (reference
                # EdgeKernel::Event{Multiply}, emit_frame.rs event drains)
                r = rate if rate is not None else inst.rate
                if r == 1:
                    return buf
                return EventBuffer(np.asarray(buf.offsets) * r,
                                   buf.values, buf.valid)

            edges = prog.edges_by_dst.get((name, ep), [])
            if inst.count > 1:
                # last-write-wins per instance queue (connect semantics);
                # the dense [count, cap] buffers are built in ONE pass
                # filling only event-bearing rows (O(events), not
                # O(voices) EventBuffer objects — prepass cost matters on
                # the MIDI-dense path)
                cnt = inst.count
                per_inst: List[Any] = [_EMPTY_EVS] * cnt
                for e in edges:
                    evs = source_events(e)
                    if e.dst_index is not None:
                        per_inst[e.dst_index] = evs
                    elif evs and isinstance(evs[0], list):
                        for i in range(min(len(evs), cnt)):
                            per_inst[i] = evs[i]
                    else:
                        per_inst = [evs] * cnt
                nmax = max((len(v) for v in per_inst), default=0)
                cap = _round_capacity(nmax)
                off = np.zeros((cnt, cap), np.int32)
                val = np.zeros((cnt, cap), np.float32)
                ok = np.zeros((cnt, cap), bool)
                for i, evs in enumerate(per_inst):
                    if not evs:
                        continue
                    evs = sorted(evs, key=lambda x: x.frame_offset)
                    evs = evs[:MAX_STATIC_EVENTS_PER_ENDPOINT]
                    for j, ev2 in enumerate(evs):
                        off[i, j] = ev2.frame_offset
                        val[i, j] = ev2.scalar
                        ok[i, j] = True
                ev_bufs[f"{name}.{ep}"] = _scale(
                    EventBuffer(off, val, ok))
            else:
                evs = []
                for e in edges:  # last-write-wins (connect semantics)
                    src_evs = source_events(e)
                    if e.source.index is not None and src_evs \
                            and isinstance(src_evs[0], list):
                        src_evs = src_evs[e.source.index]
                    evs = list(src_evs)
                cap = _round_capacity(len(evs))
                ev_bufs[f"{name}.{ep}"] = _scale(
                    EventBuffer.from_events(evs, cap))

        host_vals = {}
        for (n, ep), arr in val_env.items():
            if isinstance(arr, _StepStack):
                host_vals[f"__hstep__{n}.{ep}"] = arr.data     # (3, C)
            elif isinstance(arr, StepValue):
                if _step_staging_on():
                    host_vals[f"__hstep__{n}.{ep}"] = np.array(
                        [arr.base, arr.target,
                         min(arr.offset, block_len - 1)], np.float32)
                else:
                    host_vals[f"__host__{n}.{ep}"] = arr.materialize(
                        block_len)
            else:
                host_vals[f"__host__{n}.{ep}"] = arr

        # graph event outputs (routed host-side)
        self._last_event_outs = {}
        for o in ir.outputs:
            if o.kind != Kind.EVENT:
                continue
            expr = ir.output_edges.get(o.name)
            if isinstance(expr, EndpointRef):
                self._last_event_outs[o.name] = list(
                    ev_env.get((expr.node, expr.endpoint), []))
            else:
                self._last_event_outs[o.name] = []
        return ev_bufs, host_vals

    # ------------------------------------------------------------------ #
    def _literal_params(self) -> Dict[str, float]:
        """Values of graph VALUE inputs that have NEVER been set (they
        still hold their compile-time defaults), exposed to nodes'
        ``literal_ins`` for trace-time SPECIALIZATION decisions — e.g. a
        pivot whose ``filter_env_amount`` was never raised compiles the
        cutoff-modulation MulAdd as a constant pass-through (the ·0 term
        dropped) so the filter hoists its coefficients with no runtime
        cond.  The parameters themselves STAY runtime [1] operands
        (bit-exactness: XLA folding transcendentals of literals rounds
        differently than the runtime f32 ops — measured 2.3e-5 relative
        on the pivot — so only the zero/branch decisions specialize,
        never the arithmetic values).  The first setter flips
        ``touched`` and drops the specialization (one bounded retrace;
        the trace cache is keyed on these values).
        ``OSCEN_LITERAL_PARAMS=0`` disables the specialization class."""
        import os
        if os.environ.get("OSCEN_LITERAL_PARAMS", "1") == "0":
            return {}
        return {name: float(r.current)
                for name, r in self._params.items() if not r.touched}

    def _make_scan_fn(self, block_len: int):
        """The sample-mode (per-sample lax.scan) block function, fresh
        and unjitted — _get_block_fn wraps/caches it; explain() calls it
        directly so the trace (and its explain notes) actually reruns."""
        step = self._step

        def block_fn(state, per_block, ev_bufs):
            from .block_mode import reconstruct_step_values
            ts = jnp.arange(block_len, dtype=jnp.int32)
            per_block = reconstruct_step_values(per_block, block_len)
            # idle params stage as [1] arrays (materialize_block); the
            # per-sample scan needs a full leading time axis
            per_block = {
                k: jnp.broadcast_to(v, (block_len,) + v.shape[1:])
                if v.ndim >= 1 and v.shape[0] == 1 and block_len != 1
                else v
                for k, v in per_block.items()}

            def body(carry, xs):
                t, ps = xs
                return step(carry, t, ps, ev_bufs)

            state, outs = jax.lax.scan(body, state, (ts, per_block))
            return state, outs

        return block_fn

    def _get_block_fn(self, block_len: int, ev_caps: Tuple,
                      stream_keys: Tuple):
        lits = self._literal_params()
        key = (self.mode, block_len, ev_caps, stream_keys,
               tuple(sorted(lits.items())))
        fn = self._block_fn_cache.get(key)
        if fn is not None:
            return fn

        prog = self.prog
        block_fn = self._make_scan_fn(block_len)
        shard = getattr(self, "_shard", None)
        if self.mode == "block":
            from .block_mode import make_block_fn
            if shard is not None:
                mesh, axis = shard
                inner = make_block_fn(prog, block_len,
                                      shard=(axis, mesh.devices.size),
                                      literal_params=lits)
                block_fn = self._wrap_shard_map(inner, mesh, axis)
            else:
                block_fn = make_block_fn(prog, block_len,
                                         literal_params=lits)

        if self._jit:
            block_fn = jax.jit(block_fn)
        self._block_fn_cache[key] = block_fn
        return block_fn

    # ------------------------------------------------------------------ #
    def enable_sharding(self, mesh, axis_name: str = "voices") -> None:
        """Switch block-mode execution to SPMD over ``mesh``: the block
        function runs under ``shard_map`` with every node array's voice
        axis sharded, fan-in mix-downs as explicit psums, and
        host-staged per-voice arrays/event buffers sliced per device
        (SURVEY §5.8's scale-out design, executed rather than placed)."""
        if self.mode != "block":
            raise ValueError("sharded execution requires block mode")
        self._shard = (mesh, axis_name)
        self._block_fn_cache.clear()
        self._staging_cache.clear()
        self._control_dirty = True

    def _shard_specs(self, tree, mesh, axis):
        """Per-leaf PartitionSpecs: leading-instance-axis leaves of node
        arrays shard over ``axis``; host-staged [B, C] value arrays shard
        axis 1; everything else replicates."""
        from jax.sharding import PartitionSpec as P
        D = mesh.devices.size
        counts = {ir_name: inst.count
                  for ir_name, inst in self.ir.nodes.items()
                  if inst.count > 1}
        host_c = {f"{pfx}{n}.{ep.name}": inst.count
                  for n, inst in self.ir.nodes.items() if inst.count > 1
                  for ep in inst.node.OUTPUTS
                  for pfx in ("__host__", "__hstep__")}

        def spec_state(name, x):
            c = counts.get(name)
            x = jnp.asarray(x)
            if c is not None and x.ndim >= 1 and x.shape[0] == c \
                    and c % D == 0:
                return P(axis, *([None] * (x.ndim - 1)))
            return P(*([None] * x.ndim))

        if isinstance(tree, dict) and "__fb__" in tree:  # the state dict
            out = {}
            for name, sub in tree.items():
                if name == "__fb__":
                    # keys are "<node>.<endpoint>"; node names may contain
                    # dots (flattened subgraphs), endpoint names never do
                    out[name] = {
                        k: spec_state(k.rsplit(".", 1)[0], v)
                        for k, v in sub.items()}
                else:
                    out[name] = jax.tree_util.tree_map(
                        lambda x, name=name: spec_state(name, x), sub)
            return out
        # per_block dict: host-value arrays [B, C] shard axis 1
        out = {}
        for k, v in tree.items():
            v = jnp.asarray(v)
            c = host_c.get(k)
            if c is not None and v.ndim >= 2 and v.shape[1] == c \
                    and c % D == 0:
                out[k] = P(None, axis, *([None] * (v.ndim - 2)))
            else:
                out[k] = P(*([None] * v.ndim))
        return out

    def _wrap_shard_map(self, inner, mesh, axis):
        from jax.sharding import PartitionSpec as P
        try:
            from jax import shard_map  # jax >= 0.8
        except ImportError:
            from jax.experimental.shard_map import shard_map
        cache = {}

        def call(state, per_block, ev_bufs):
            if "f" not in cache:
                st_specs = self._shard_specs(state, mesh, axis)
                pb_specs = self._shard_specs(per_block, mesh, axis)
                ev_specs = {
                    k: jax.tree_util.tree_map(
                        lambda x, k=k: self._ev_spec(k, x, mesh, axis), v)
                    for k, v in ev_bufs.items()}
                # outputs: streams replicated after the psums (prefix
                # spec covers the whole outs subtree)
                out_specs = (st_specs, P())
                cache["f"] = shard_map(
                    inner, mesh=mesh,
                    in_specs=(st_specs, pb_specs, ev_specs),
                    out_specs=out_specs, check_vma=False)
            return cache["f"](state, per_block, ev_bufs)

        return call

    def _ev_spec(self, key, x, mesh, axis):
        """Spec for one event-buffer leaf, keyed by the owning
        ``node.endpoint``: only buffers of node *arrays* shard their
        leading (instance) axis — a scalar node's buffer whose capacity
        happens to equal some array count must replicate, or events would
        be silently dropped on most devices."""
        from jax.sharding import PartitionSpec as P
        D = mesh.devices.size
        x = jnp.asarray(x)
        # key = "<node>.<endpoint>"; node names may themselves contain
        # dots (flattened subgraphs), endpoint names never do
        inst = self.ir.nodes.get(key.rsplit(".", 1)[0])
        count = inst.count if inst is not None else 1
        if count > 1 and count % D == 0 and x.ndim >= 1 \
                and x.shape[0] == count:
            return P(axis, *([None] * (x.ndim - 1)))
        return P(*([None] * x.ndim))

    # ------------------------------------------------------------------ #
    def _control_steady(self) -> bool:
        """True when block-to-block staging is reproducible: no pending
        control changes, no active ramps, and every host node declares
        itself event-driven (``HOST_STEADY``)."""
        if self._control_dirty:
            return False
        if any(r.frames_remaining > 0 for r in self._params.values()):
            return False
        return all(
            getattr(self.ir.nodes[n].node, "HOST_STEADY", False)
            for n in self.prog.host_nodes)

    def process_block(self, block_len: Optional[int] = None,
                      stream_inputs: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, jnp.ndarray]:
        """Advance one block; returns {output name: [B(,C)] array}."""
        B = int(block_len or self.block_size)
        steady = stream_inputs is None and self._control_steady()
        if steady and B in self._staging_cache:
            per_block, ev_bufs, fn = self._staging_cache[B]
            self.state, outs = fn(self.state, per_block, ev_bufs)
            return dict(outs)
        self._control_dirty = False  # staging below consumes everything
        ev_bufs, host_vals = self._host_prepass(B)

        # Event-bearing blocks pack all per-block control staging (param
        # blocks, host values, event buffers) into ONE f32 vector and a
        # single host->device transfer, unpacked inside the jitted
        # wrapper: each host->device transfer pays a fixed latency, so
        # one packed transfer replaces a dozen small ones on the
        # MIDI-dense path.  Param-only control changes keep the per-array path —
        # their staging shapes equal the steady block's, so they REUSE
        # the steady-compiled variant instead of adding a packed one
        # (pinned by tests/test_realtime_safety.py).
        # OSCEN_PACKED_STAGING=0 restores per-array staging everywhere.
        has_events = any(v.capacity > 0 for v in ev_bufs.values()) or any(
            k.startswith("__hstep__") for k in host_vals)
        packed_on = (self._jit and getattr(self, "_shard", None) is None
                     and not steady and has_events and _packed_staging_on())

        per_block: Dict[str, Any] = {}
        dyn_np: Dict[str, np.ndarray] = {}
        for gi in self.ir.inputs:
            if gi.kind == Kind.VALUE:
                arr = self._params[gi.name].materialize_block(B)
                if packed_on:
                    dyn_np[gi.name] = arr
                else:
                    per_block[gi.name] = jnp.asarray(arr)
            elif gi.kind == Kind.STREAM:
                if stream_inputs and gi.name in stream_inputs:
                    arr = jnp.asarray(stream_inputs[gi.name],
                                      jnp.float32)
                    if arr.shape[0] < B:  # pad like BlockRender
                        pad = [(0, B - arr.shape[0])] + \
                            [(0, 0)] * (arr.ndim - 1)
                        arr = jnp.pad(arr, pad)
                    per_block[gi.name] = arr[:B]
                else:
                    shape = (B,) if gi.channels == 1 else (B, gi.channels)
                    per_block[gi.name] = self._cached_zeros(shape)
        for k, arr in host_vals.items():
            if packed_on:
                dyn_np[k] = np.asarray(arr, np.float32)
            else:
                per_block[k] = jnp.asarray(arr)

        ev_caps = tuple(sorted((k, v.capacity)
                               for k, v in ev_bufs.items()))
        if packed_on:
            self._staging_cache = {}
            fn, packed = self._packed_call(B, ev_caps, per_block,
                                           dyn_np, ev_bufs)
            self.state, outs = fn(self.state, packed, per_block)
        else:
            fn = self._get_block_fn(B, ev_caps, tuple(sorted(per_block)))
            if steady:
                # this block's staging was clean-entry, so it reproduces
                # verbatim until the next control change: cache it
                # (device arrays stay resident — a steady block becomes
                # one jit call)
                self._staging_cache = {B: (per_block, ev_bufs, fn)}
            else:
                # events/param changes just altered host-node outputs —
                # any previously cached staging is stale now
                self._staging_cache = {}
            self.state, outs = fn(self.state, per_block, ev_bufs)
        outs = dict(outs)
        outs.update(getattr(self, "_last_event_outs", {}))
        return outs

    def _cached_zeros(self, shape):
        z = self._zeros_cache.get(shape)
        if z is None:
            z = jnp.zeros(shape, jnp.float32)
            self._zeros_cache[shape] = z
        return z

    def _packed_call(self, B: int, ev_caps: Tuple, dev_pb: Dict[str, Any],
                     dyn_np: Dict[str, np.ndarray],
                     ev_bufs: Dict[str, EventBuffer]):
        """Build (cached wrapper fn, packed f32 vector) for one
        non-steady block: the wrapper slices the packed vector back into
        the per-block dict and event buffers (static spec — fused into
        the block program) and calls the inner block fn.  Event offsets
        ride as f32 (exact below 2**24; offsets are <= B*rate <= 32768)
        and the valid mask as 0/1."""
        spec = tuple(
            [("pb", k, tuple(np.shape(dyn_np[k]))) for k in sorted(dyn_np)]
            + [("ev", k, tuple(np.shape(np.asarray(ev_bufs[k].offsets))))
               for k in sorted(ev_bufs)])
        all_keys = tuple(sorted(set(dev_pb) | set(dyn_np)))
        # the wrapper closes over an inner built with the CURRENT
        # literal-param specializations — key on them, or an event block
        # after the first set_value() would reuse a stale specialized fn
        key = ("packed", self.mode, B, ev_caps, spec,
               tuple(sorted(dev_pb)),
               tuple(sorted(self._literal_params().items())))
        fn = self._block_fn_cache.get(key)
        if fn is None:
            inner = self._get_block_fn(B, ev_caps, all_keys)

            def packed_fn(state, packed, dev_pb):
                pb = dict(dev_pb)
                ebs = {}
                pos = 0
                for kind, k, shape in spec:
                    n = int(np.prod(shape))
                    if kind == "pb":
                        pb[k] = packed[pos:pos + n].reshape(shape)
                        pos += n
                    else:
                        off = packed[pos:pos + n].reshape(shape).astype(
                            jnp.int32)
                        pos += n
                        val = packed[pos:pos + n].reshape(shape)
                        pos += n
                        ok = packed[pos:pos + n].reshape(shape) > 0.5
                        pos += n
                        ebs[k] = EventBuffer(off, val, ok)
                return inner(state, pb, ebs)

            fn = jax.jit(packed_fn)
            self._block_fn_cache[key] = fn

        parts = []
        for kind, k, _shape in spec:
            if kind == "pb":
                parts.append(np.asarray(dyn_np[k], np.float32).ravel())
            else:
                b = ev_bufs[k]
                parts.append(np.asarray(b.offsets, np.float32).ravel())
                parts.append(np.asarray(b.values, np.float32).ravel())
                parts.append(np.asarray(b.valid, np.float32).ravel())
        packed = (np.concatenate(parts) if parts
                  else np.zeros((1,), np.float32))
        return fn, jnp.asarray(packed)

    # ------------------------------------------------------------------ #
    def render(self, num_frames: int,
               stream_inputs: Optional[Dict[str, Any]] = None,
               tail: int = 0) -> Dict[str, np.ndarray]:
        """Offline render (BlockRender analogue, graph/offline.rs:19-113):
        chunked block processing, input padding, tail silence.  A driver
        over :meth:`process_block`, not a different algorithm — and output
        is bit-identical across block sizes for block-constant node
        parameters (sequential-exact phase/IIR scans + stage-entry-based
        envelope closed forms; see tests/test_block_invariance.py)."""
        total = int(num_frames) + int(tail)
        chunks: List[Dict[str, Any]] = []
        pos = 0
        while pos < total:
            n = min(self.block_size, total - pos)
            si = None
            if stream_inputs:
                si = {k: np.asarray(v)[pos:pos + n]
                      for k, v in stream_inputs.items()}
            chunks.append(self.process_block(n, si))
            pos += n
        out: Dict[str, np.ndarray] = {}
        for o in self.ir.outputs:
            if o.kind == Kind.EVENT:
                continue
            out[o.name] = np.concatenate(
                [np.asarray(c[o.name]) for c in chunks], axis=0)[:total]
        return out

    def render_steady(self, num_blocks: int,
                      block_len: Optional[int] = None
                      ) -> Dict[str, jnp.ndarray]:
        """Fused steady-state rendering: scan the block function over
        ``num_blocks`` blocks entirely on device (no events, parameters
        frozen at their current values).  One host dispatch for the whole
        span — the serving-path analogue of a long audio callback run,
        and the right way to benchmark (per-block host staging would
        otherwise dominate at >100x realtime)."""
        B = int(block_len or self.block_size)
        ev_bufs, per_block, ev_caps = self._steady_staging(B)
        key = ("steady", self.mode, B, ev_caps, tuple(sorted(per_block)),
               int(num_blocks),
               tuple(sorted(self._literal_params().items())))
        fn = self._block_fn_cache.get(key)
        if fn is None:
            inner = self._get_block_fn(B, ev_caps, tuple(sorted(per_block)))

            def steady(state, per_block, ev_bufs):
                def body(st, _):
                    return inner(st, per_block, ev_bufs)
                return jax.lax.scan(body, state, None, length=num_blocks)

            fn = jax.jit(steady) if self._jit else steady
            self._block_fn_cache[key] = fn
        self.state, outs = fn(self.state, per_block, ev_bufs)
        # outs: [num_blocks, B, ...] -> concat time
        return {k: jnp.reshape(v, (-1,) + v.shape[2:])
                for k, v in outs.items()}

    def _steady_staging(self, B: int):
        """Event-free per-block staging at the CURRENT parameter values
        (shared by render_steady / steady_checksum / explain)."""
        ev_bufs, host_vals = self._host_prepass(B)
        per_block: Dict[str, Any] = {}
        for gi in self.ir.inputs:
            if gi.kind == Kind.VALUE:
                per_block[gi.name] = jnp.asarray(
                    self._params[gi.name].materialize_block(B))
            elif gi.kind == Kind.STREAM:
                shape = (B,) if gi.channels == 1 else (B, gi.channels)
                per_block[gi.name] = jnp.zeros(shape, jnp.float32)
        for k, arr in host_vals.items():
            per_block[k] = jnp.asarray(arr)
        ev_caps = tuple(sorted((k, v.capacity) for k, v in ev_bufs.items()))
        return ev_bufs, per_block, ev_caps

    def node_state(self, name: str):
        """Read a node's current state pytree (all node state is
        inspectable, like the reference's public generated fields)."""
        return self.state[name]

    def explain(self, block_len: Optional[int] = None,
                formatted: bool = False):
        """Report how each node executes in the steady-state block path:
        kernel selection, fast-path conditions met/unmet (const-dt,
        zero-feedback, epilogue fusion, scan island vs dissolved), and
        which inputs were provably block-constant at trace time.

        The perf contract is otherwise implicit in trace-time branches
        and runtime ``lax.cond`` predicates (e.g. the FM chain silently
        loses its vectorized branch when a feedback param goes nonzero);
        this surfaces it.  The trace is abstract (``jax.eval_shape`` —
        no device execution, no state advance) against the CURRENT
        parameter staging, so flipping a param and calling ``explain()``
        again shows the resulting path change.  Host-side state the
        staging prepass would normally advance (queued events, ramp
        positions, host-node control state such as the voice allocator's
        LRU order) is snapshotted and restored — explain() observes, it
        never consumes.  Returns a list of note dicts (one or more per
        node), or a formatted string with ``formatted=True``."""
        import copy

        from . import explain as _explain
        B = int(block_len or self.block_size)
        saved_queues = {k: list(q) for k, q in self._event_queues.items()}
        saved_params = copy.deepcopy(self._params)
        saved_hosts: Dict[str, Any] = {}
        for name in self.prog.host_nodes:
            if self.ir.nodes[name].count == 1:
                saved_hosts[name] = copy.deepcopy(
                    self.ir.nodes[name].node.__dict__)
            else:
                saved_hosts[name] = [
                    copy.deepcopy(n.__dict__)
                    for n in self.prog.host_instances[name]]
        saved_ev_outs = getattr(self, "_last_event_outs", None)
        try:
            ev_bufs, per_block, ev_caps = self._steady_staging(B)
            # A FRESH unjitted block fn: jit caches traces, so re-using
            # the cached jitted fn would skip retracing (and with it the
            # explain notes) on every call after the first.  per_block is
            # closed over CONCRETELY rather than passed as an eval_shape
            # argument, so parameter-dependent predicates (zero-feedback,
            # block-constant coefficient hoists) resolve against the
            # CURRENT values instead of reporting "runtime".
            if self.mode == "block":
                from .block_mode import make_block_fn
                fn = make_block_fn(self.prog, B,
                                   literal_params=self._literal_params())
            else:
                # fresh UNJITTED fn: the cached jitted one would reuse
                # its trace and the explain notes would never fire
                fn = self._make_scan_fn(B)
            entries: list = []
            with _explain.recording(entries):
                jax.eval_shape(lambda s, eb: fn(s, per_block, eb),
                               self.state, ev_bufs)
        finally:
            for k, evs in saved_queues.items():
                self._event_queues[k].clear()
                self._event_queues[k].extend(evs)
            self._params = saved_params
            for name, saved in saved_hosts.items():
                if self.ir.nodes[name].count == 1:
                    self.ir.nodes[name].node.__dict__.update(saved)
                else:
                    for n, s in zip(self.prog.host_instances[name], saved):
                        n.__dict__.update(s)
            if saved_ev_outs is not None:
                self._last_event_outs = saved_ev_outs
        # Resolve value predicates the trace could not (live params): the
        # host knows every control-rate value it stages, exactly as the
        # reference's control thread owns its params.
        for e in entries:
            if e.get("engaged") is None and e.get("predicate") == "all_zero":
                vals = [self._host_input_value(e["node"], ep)
                        for ep in e.get("predicate_eps", ())]
                if any(v is None for v in vals):
                    e["engaged"] = ("runtime(all == 0; source not " +
                                    "host-resolvable)")
                else:
                    e["engaged"] = all(v == 0.0 for v in vals)
        if formatted:
            return _explain.format_report(entries)
        return entries

    def _host_input_value(self, node_name: str, ep_name: str):
        """Current host-known value of a node's VALUE input: literal
        Consts, arithmetic over them, and live graph params (their
        current ramp value).  None when any feeding source is computed
        on device (a stream / another node's output).

        NOTE: the edge-eligibility and arithmetic rules here must agree
        with block_mode.py's ``literal_eps`` evaluator — explain()'s
        predicate resolution reports which branch the trace specialized,
        so the two walks must classify the same expressions the same
        way."""
        def ev(ex):
            if isinstance(ex, Const):
                return float(ex.value)
            if isinstance(ex, BinOp):
                l, r = ev(ex.lhs), ev(ex.rhs)
                if l is None or r is None or ex.op not in "+-*/":
                    return None
                if ex.op == "/" and r == 0.0:
                    return None  # not host-resolvable, not a crash
                return {"+": l + r, "-": l - r,
                        "*": l * r, "/": l / r if r else None}[ex.op]
            if isinstance(ex, EndpointRef):
                if ex.node == "" and ex.endpoint in self._params:
                    return float(self._params[ex.endpoint].current)
                return None
            return None

        edges = self.prog.edges_by_dst.get((node_name, ep_name), [])
        inst = self.ir.nodes[node_name]
        if not edges:
            for ep in inst.node.INPUTS:
                if ep.name == ep_name:
                    return float(ep.default or 0.0)
            return None
        total = None
        for e in edges:
            if (e.kernel != EdgeKernel.NONE or e.is_feedback
                    or e.dst_index is not None):
                return None
            v = ev(e.source)
            if v is None:
                return None
            total = v if total is None else total + v
        return total

    def latency_samples(self) -> int:
        """Total base-rate latency introduced by cross-rate Down edges
        (reference emit_struct.rs:534-570: sum of down-kernel latency
        divided by the rate factor)."""
        total = 0
        for idx, kern in self.prog.resamplers.items():
            e = self.ir.edges[idx]
            if e.kernel == EdgeKernel.DOWN:
                total += kern.latency_samples() // e.rate_factor
        return total

    def steady_checksum(self, num_blocks: int,
                        block_len: Optional[int] = None) -> float:
        """Render ``num_blocks`` steady-state blocks on device and return
        only a scalar energy checksum.  The throughput measurement
        primitive: all compute is forced (the checksum depends on every
        sample) while transfer is 4 bytes, so the time is the device's
        (timing two span lengths and subtracting also cancels the fixed
        per-call cost)."""
        B = int(block_len or self.block_size)
        ev_bufs, per_block, ev_caps = self._steady_staging(B)
        # The span length is a RUNTIME argument (fori_loop, not a
        # static-length scan) so one compile serves every span — the
        # bench warms up in one compile per block size instead of one
        # per (block size, span) pair, which halved its wall budget.
        key = ("steady_ck", self.mode, B, ev_caps,
               tuple(sorted(per_block)),
               tuple(sorted(self._literal_params().items())))
        fn = self._block_fn_cache.get(key)
        if fn is None:
            inner = self._get_block_fn(B, ev_caps, tuple(sorted(per_block)))
            stream_outs = [o.name for o in self.ir.outputs
                           if o.kind != Kind.EVENT]

            def steady_ck(state, per_block, ev_bufs, n):
                def body(_, carry):
                    st, acc = carry
                    st, outs = inner(st, per_block, ev_bufs)
                    return (st, acc + sum(jnp.sum(outs[nm] ** 2)
                                          for nm in stream_outs))
                return jax.lax.fori_loop(
                    0, n, body, (state, jnp.float32(0.0)))

            fn = jax.jit(steady_ck) if self._jit else steady_ck
            self._block_fn_cache[key] = fn
        self.state, ck = fn(self.state, per_block, ev_bufs,
                            jnp.int32(num_blocks))
        return float(np.asarray(ck))

    def render_mono(self, num_frames: int, **kw) -> np.ndarray:
        outs = self.render(num_frames, **kw)
        if len(outs) != 1:
            raise ValueError("render_mono requires exactly one output")
        return next(iter(outs.values()))
