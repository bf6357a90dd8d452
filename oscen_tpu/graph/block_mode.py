"""Block-mode codegen: time-vectorized per-node execution.

The fast path (SURVEY §7 step 9): instead of one fused per-sample scan over
the whole graph (sample mode — the op-order parity path), each node
processes the whole ``[B]`` block at once via its vectorized
``process_block`` (cumsum phases, associative scans, closed-form
envelopes).  Per-sample sequencing survives only where it must:

- nodes caught in feedback cycles form **scan islands** — strongly
  connected components (over normal + feedback edges) executed by a
  per-sample ``lax.scan`` restricted to the island;
- cross-island feedback edges become one-sample shifts of whole blocks,
  with the carry in ``state["__fb__"]`` (bit-identical to the sample-mode
  previous-sample read).

Value convention inside a block: scalar nodes see time-leading ``[B, ...]``
arrays; node arrays are instance-leading ``[C, B, ...]`` and vmapped.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.events import EventBuffer
from ..core.types import Kind
from . import explain
from .ir import (BinOp, Call, Const, EdgeKernel, EndpointRef, Fanout,
                 FrameCtor, IrEdge)

__all__ = ["make_block_fn", "reconstruct_step_values"]


def reconstruct_step_values(per_block: Dict[str, Any],
                            B: int) -> Dict[str, Any]:
    """Expand ``__hstep__<node>.<ep>`` step-staging tensors into the
    ``__host__<node>.<ep>`` per-sample arrays the block/sample bodies
    consume.  A ``(3[, C])`` base/target/offset tensor becomes
    ``[B(, C)]`` via one vectorized select — the heavy array exists only
    on device (see graph/node.py StepValue for the why and the measured
    host-transfer cost it removes)."""
    if not any(k.startswith("__hstep__") for k in per_block):
        return per_block
    t = jnp.arange(B, dtype=jnp.float32)
    out = {}
    for k, v in per_block.items():
        if not k.startswith("__hstep__"):
            out[k] = v
            continue
        v = jnp.asarray(v)
        base, tgt, off = v[0], v[1], v[2]
        if v.ndim == 2:   # (3, C) -> [B, C]
            vals = jnp.where(t[:, None] >= off[None, :],
                             tgt[None, :], base[None, :])
        else:             # (3,)  -> [B]
            vals = jnp.where(t >= off, tgt, base)
        out["__host__" + k[len("__hstep__"):]] = vals
    return out


def _sccs(nodes: List[str], deps: Dict[str, set]) -> List[List[str]]:
    """Tarjan SCCs; returns components in reverse topological order of the
    condensed DAG (so we reverse before use)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str):
        # iterative Tarjan to dodge recursion limits
        work = [(v, iter(sorted(deps.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack[v] = True
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(sorted(deps.get(w, ())))))
                    advanced = True
                    break
                elif on_stack.get(w):
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)

    for v in nodes:
        if v not in index:
            strongconnect(v)
    return out


def make_block_fn(prog, block_len: int, shard=None, literal_params=None):
    """Build the block-mode traced function
    ``(state, per_block, ev_bufs) -> (state, out_blocks)``.

    ``shard=(axis_name, n_shards)`` builds the *per-device* body for
    ``shard_map`` execution over a voice mesh: every node array's
    instance axis is its local shard (``count // n_shards``), fan-in
    sums over the instance axis finish with an explicit
    ``jax.lax.psum`` over the mesh axis (the reference's FanIn edge,
    emit_edge.rs:67-84, as a collective), and graph-output
    instance-axis reductions likewise.  Host-staged per-voice value
    arrays arrive pre-sliced by shard_map's in_specs.

    ``literal_params``: current values of never-touched graph VALUE
    inputs (see CompiledGraph._literal_params), reported through
    ``literal_eps`` so nodes can SPECIALIZE branches on them (e.g. a
    literal-0.0 modulation amount compiles its whole path away).  The
    params themselves remain runtime [1] operands — only decisions
    specialize, never arithmetic values (bit-exactness: XLA folding
    transcendentals of literals rounds differently than runtime f32).
    """
    literal_params = literal_params or {}
    ir = prog.ir
    B = block_len
    shard_axis, n_shards = shard if shard is not None else (None, 1)

    def eff(count: int) -> int:
        """Local (per-device) instance count for a node array."""
        if shard_axis is not None and count > 1:
            if count % n_shards:
                raise ValueError(
                    f"voice count {count} not divisible by the "
                    f"{n_shards}-device mesh")
            return count // n_shards
        return count

    def _psum(v):
        if shard_axis is not None:
            return jax.lax.psum(v, shard_axis)
        return v

    # dependency graph over device nodes (normal + feedback edges)
    deps: Dict[str, set] = {n: set() for n in prog.device_nodes}
    fb_internal_edges: List[IrEdge] = []
    for e in ir.edges:
        if e.dst_node not in deps:
            continue
        for r in e.source.endpoints():
            if r.node and r.node in deps and r.node != e.dst_node:
                deps[e.dst_node].add(r.node)

    # Tarjan pops sink components first; with edges pointing at
    # prerequisites that IS evaluation order (dependencies first).
    comps = _sccs(prog.device_nodes, deps)
    comp_of: Dict[str, int] = {}
    for i, comp in enumerate(comps):
        for n in comp:
            comp_of[n] = i
    # preserve sample-mode topo order inside each island
    topo_pos = {n: i for i, n in enumerate(ir.order)}
    comps = [sorted(c, key=lambda n: topo_pos[n]) for c in comps]

    def is_island(comp: List[str]) -> bool:
        if len(comp) > 1:
            return True
        n = comp[0]
        return n in deps.get(n, ()) or any(
            e.is_feedback and e.src_reads_state and e.dst_node == n
            and all(r.node == n for r in e.source.endpoints() if r.node)
            for e in ir.edges)

    islands = [c for c in comps if len(c) > 1]

    # FanIn fusion: node-array outputs whose ONLY consumers are bare
    # full-instance fan-in sums (and which feed no island, feedback
    # snapshot, or graph output expression) may be pre-reduced inside the
    # producing node's batched kernel — the voice mixdown never reaches
    # device memory.  The node advertises support by accepting a ``fanin_eps``
    # kwarg in process_block_batched and returning ``__fanin__<ep>``.
    import os as _os
    _fusion_on = _os.environ.get("OSCEN_FANIN_FUSION", "1") != "0"
    island_nodes = {n for c in comps if is_island(c) for n in c}
    _consumers: Dict[Tuple[str, str], List[IrEdge]] = {}
    for e in ir.edges:
        for r in e.source.endpoints():
            if r.node:
                _consumers.setdefault((r.node, r.endpoint), []).append(e)
    _out_refs = {(r.node, r.endpoint)
                 for expr in ir.output_edges.values()
                 for r in expr.endpoints() if r.node}
    _fb_refs = set(prog.fb_keys)
    fanin_only: Dict[str, frozenset] = {}
    for _name in prog.device_nodes:
        _inst = ir.nodes[_name]
        if _inst.count <= 1:
            continue
        _eps = set()
        for _ep in _inst.node.OUTPUTS:
            key = (_name, _ep.name)
            _edges = _consumers.get(key, [])
            if _edges and key not in _out_refs and key not in _fb_refs \
                    and all(isinstance(e.source, EndpointRef)
                            and e.fanout == Fanout.FAN_IN
                            and e.dst_index is None
                            and e.kernel == EdgeKernel.NONE
                            and not e.is_feedback
                            and e.dst_node not in island_nodes
                            for e in _edges):
                _eps.add(_ep.name)
        if _eps and _fusion_on:
            fanin_only[_name] = frozenset(_eps)

    def node_count(name: str) -> int:
        return ir.nodes[name].count

    def _local_default(inst, ep):
        """Per-sample default value sized to the *local* (per-device)
        instance count for island scans under shard_map."""
        v = prog._default_value(inst, ep)
        if shard_axis is not None and inst.count > 1:
            v = v[:eff(inst.count)]
        return v

    # ---- island dissolution plans ------------------------------------ #
    # A feedback island whose every cycle passes through a Delay with a
    # static ``min_delay >= B + 4`` promise dissolves into acyclic block
    # evaluation: the delay reads its whole block from pre-block buffer
    # contents first, the remaining nodes evaluate as normal vectorized
    # block nodes (stale feedback reads become one-sample block shifts,
    # already handled by resolve_block), and the delay writes last.  This
    # replaces the per-sample island scan — the simple-echo topology goes
    # from a B-step scan to three vectorized phases.
    from ..nodes.delay import Delay as _Delay

    def _dissolve_plan(comp):
        if len(comp) == 1 and not is_island(comp):
            return None
        if any(ir.nodes[n].rate != 1 for n in comp):
            return None
        cset = set(comp)
        dels = [n for n in comp
                if isinstance(ir.nodes[n].node, _Delay)
                and ir.nodes[n].node.min_delay >= B + 4
                and ir.nodes[n].count == 1]
        if not dels:
            return None
        dset = set(dels)
        for d in dels:
            for epn in ("delay_samples", "feedback"):
                for e in prog.edges_by_dst.get((d, epn), []):
                    if any(r.node in cset
                           for r in e.source.endpoints()):
                        return None  # params fed from inside the island
        rest = [n for n in comp if n not in dset]
        sub = {n: (deps[n] & cset) - dset for n in rest}
        order = []
        pending = dict(sub)
        while pending:
            ready = [n for n, d_ in pending.items()
                     if not (d_ & set(pending))]
            if not ready:
                return None  # a cycle not broken by the delays
            ready.sort(key=lambda n: topo_pos[n])
            order.extend(ready)
            for n in ready:
                del pending[n]
        return dels, order

    dissolve_plans = [_dissolve_plan(c) for c in comps]

    # ------------------------------------------------------------------ #
    def block_fn(state, per_block, ev_bufs):
        # step-staged host values ((3[, C]) base/target/offset) expand to
        # their per-sample arrays on device before anything reads them
        per_block = reconstruct_step_values(per_block, B)
        # idle params stage as [1] arrays (ValueRampState.materialize_
        # block): broadcast to the full time axis here so every consumer
        # sees the usual [B] shape while XLA still proves the values
        # block-constant (broadcast-of-scalar) — connected-but-idle
        # params then fold like unconnected defaults instead of
        # inflating whole-block math
        # per_block entries staged as [1]-leading are block-constant THIS
        # TRACE — a trace-time fact (shape is part of the jit key) that
        # nodes can exploit to drop runtime param-change branches and
        # hoist per-sample work (see const_eps).  Covers graph inputs
        # (idle ramps, ValueRampState.materialize_block) and host-node
        # value outputs (e.g. MidiVoiceHandler frequency in blocks with
        # no note-on).
        const_inputs = {
            k for k, v in per_block.items()
            if jnp.ndim(v) >= 1 and v.shape[0] == 1 and B != 1}
        per_block = {
            k: (jnp.broadcast_to(v, (B,) + v.shape[1:])
                if jnp.ndim(v) >= 1 and v.shape[0] == 1 and B != 1 else v)
            for k, v in per_block.items()}
        env: Dict[Tuple[str, str], Any] = {}
        new_state = dict(state)
        fb = dict(state["__fb__"])
        # node outputs PROVEN block-constant at trace time (filled in
        # topo order by const_out_eps-declaring stateless nodes whose
        # inputs are const/literal — e.g. a MulAdd with literal-0.0 gain;
        # consumers' const_eps then treat edges from them as constant, so
        # const-ness propagates through stateless modulation chains)
        const_outs: set = set()

        def resolve_block(edge: Optional[IrEdge]):
            def resolve(ref: EndpointRef):
                if ref.node == "":
                    return per_block[ref.endpoint]  # [B] or [B, C]
                if ref.node in prog.host_set:
                    v = per_block[f"__host__{ref.node}.{ref.endpoint}"]
                    if v.ndim == 2:  # [B, C] -> instance-leading [C, B]
                        v = jnp.moveaxis(v, 0, 1)
                    return v
                key = (ref.node, ref.endpoint)
                v = env[key]
                if edge is not None and edge.is_feedback \
                        and edge.src_reads_state:
                    # previous-sample read: shift the block by one along
                    # time, seeding with the carry from the last block
                    taxis = 1 if node_count(ref.node) > 1 else 0
                    init = state["__fb__"][f"{ref.node}.{ref.endpoint}"]
                    init = jnp.expand_dims(init, taxis)
                    v = jnp.concatenate(
                        [init, jax.lax.slice_in_dim(v, 0, B - 1, axis=taxis)],
                        axis=taxis)
                return v
            return resolve

        def _payload_shape(ep):
            return ep.shape if ep.shape else (
                () if ep.channels == 1 else (ep.channels,))

        def _normalize(v, count, B, payload, is_array=None):
            """Normalize an evaluated edge value to the destination's
            block shape ((C,)? , B, *payload).  Missing axes are resolved
            by payload tail-matching: payload dims align at the end,
            time/instance axes are prepended.  ``is_array`` forces the
            instance axis even when the (sharded-local) count is 1."""
            if is_array is None:
                is_array = count > 1
            target = ((count,) if is_array else ()) + (B,) + payload
            v = jnp.asarray(v)
            while v.ndim < len(target):
                tail = target[len(target) - v.ndim:] if v.ndim else ()
                compatible = all(
                    s == t_ or s == 1
                    for s, t_ in zip(v.shape, tail)) if v.ndim else False
                if compatible:
                    v = v[None]          # prepend time/instance axis
                else:
                    v = v[..., None]     # broadcast into payload dims
            return jnp.broadcast_to(v, target)

        def _edge_value(e, inst, ep, resolve, indexed: bool):
            """Evaluate one edge and normalize it for its destination
            (FAN_IN summing + parallel truncation + broadcast + cross-rate
            resampling with carried kernel state)."""
            pre = None
            if e.fanout == Fanout.FAN_IN and e.dst_index is None \
                    and isinstance(e.source, EndpointRef):
                pre = env.get((e.source.node,
                               "__fanin__" + e.source.endpoint))
            if pre is not None:
                v = _psum(pre)  # mixdown fused into the producer kernel
            else:
                v = prog.eval_expr(e.source, resolve(e))
                if e.fanout == Fanout.FAN_IN and e.dst_index is None:
                    v = jnp.sum(v, axis=0)  # (local) instance axis leads
                    if any(ir.nodes[r.node].count > 1
                           for r in e.source.endpoints()
                           if r.node in ir.nodes):
                        v = _psum(v)
                elif e.fanout == Fanout.REPEAT and e.dst_index is None:
                    v = jnp.repeat(jnp.asarray(v), e.factor, axis=0)
                elif e.fanout == Fanout.SEGMENT_SUM \
                        and e.dst_index is None:
                    v = prog._segment_sum(v, e.factor)
            is_array = not indexed and inst.count > 1
            count = 1 if indexed else eff(inst.count)
            payload = _payload_shape(ep)
            src_rate = inst.rate if e.kernel == EdgeKernel.NONE else (
                1 if e.kernel == EdgeKernel.UP else e.rate_factor)
            Bsrc = B * src_rate
            if is_array and e.fanout == Fanout.PARALLEL \
                    and jnp.ndim(v) >= 1 \
                    and v.shape[0] not in (count, Bsrc):
                v = v[:count]
            v = _normalize(v, count, Bsrc, payload, is_array)
            if e.kernel in (EdgeKernel.UP, EdgeKernel.DOWN):
                idx = prog.edge_ids[id(e)]
                kern = prog.resamplers[idx]
                if is_array:
                    v = jnp.moveaxis(v, 0, -1)  # [Bsrc, *payload, C]
                st, v = kern.process_block(
                    new_state["__rs__"][str(idx)], v)
                new_state["__rs__"][str(idx)] = st
                if is_array:
                    v = jnp.moveaxis(v, -1, 0)
            return v

        def gather_block(name: str, only_eps=None) -> Dict[str, Any]:
            inst = ir.nodes[name]
            ins: Dict[str, Any] = {}
            for ep in inst.node.INPUTS:
                if ep.kind in (Kind.EVENT, Kind.ASSET):
                    continue
                if only_eps is not None and ep.name not in only_eps:
                    continue
                edges = prog.edges_by_dst.get((name, ep.name), [])
                val = None
                for e in edges:
                    v = _edge_value(e, inst, ep, resolve_block,
                                    e.dst_index is not None)
                    if e.dst_index is not None:
                        base = val if val is not None else \
                            _default_block(inst, ep, B)
                        val = base.at[e.dst_index].set(v)
                    elif val is None:
                        val = v
                    else:
                        val = val + v
                if val is None:
                    val = _default_block(inst, ep, B)
                ins[ep.name] = val
            return ins

        def const_eps(name: str) -> frozenset:
            """Input endpoints of ``name`` that are provably block-
            constant at TRACE time: unconnected (default fill) or fed
            only by plain edges whose source expression is constant —
            every EndpointRef leaf a graph input staged as [1]
            (``const_inputs``), the rest literals/arithmetic on them
            (e.g. flattened subgraph-input defaults lower to ``Const``
            expressions).  Nodes whose ``process_block`` takes a
            ``const_ins`` kwarg receive this set and may compile away
            runtime param-change branches (e.g. Tremolo's rate-ramp
            scan)."""
            inst = ir.nodes[name]
            out = set()

            def src_const(ref) -> bool:
                if ref.node == "":
                    return ref.endpoint in const_inputs
                if ref.node in prog.host_set:
                    return (f"__host__{ref.node}.{ref.endpoint}"
                            in const_inputs)
                return (ref.node, ref.endpoint) in const_outs

            def expr_const(ex) -> bool:
                if isinstance(ex, Const):
                    return True
                if isinstance(ex, BinOp):
                    return expr_const(ex.lhs) and expr_const(ex.rhs)
                if isinstance(ex, Call):
                    return all(expr_const(a) for a in ex.args)
                if isinstance(ex, FrameCtor):
                    return all(expr_const(c) for c in ex.channels)
                if isinstance(ex, EndpointRef):
                    return src_const(ex)
                return False

            for ep in inst.node.INPUTS:
                if ep.kind in (Kind.EVENT, Kind.ASSET):
                    continue
                edges = prog.edges_by_dst.get((name, ep.name), [])
                ok = True
                for e in edges:
                    if not (expr_const(e.source)
                            and e.kernel == EdgeKernel.NONE
                            and not e.is_feedback):
                        ok = False
                        break
                if ok:
                    out.add(ep.name)
            return frozenset(out)

        def literal_eps(name: str) -> dict:
            """Value endpoints of ``name`` whose staged value is a
            TRACE-TIME LITERAL: unconnected (default fill) or fed only by
            Const / arithmetic-of-Const edges (flattened subgraph-input
            defaults lower to Const, builder.py::subst_input).  Unlike
            ``const_eps`` (block-constant but runtime-valued [1]
            staging), these values are part of the trace itself — a node
            may specialize branches on them with NO runtime check (e.g.
            the FM chain compiles only its zero-feedback branch when
            every feedback is literally 0.0, the reference default).
            Returns {endpoint: float}."""
            inst = ir.nodes[name]

            def lit(ex):
                if isinstance(ex, Const):
                    return float(ex.value)
                if isinstance(ex, EndpointRef) and ex.node == "" \
                        and ex.endpoint in literal_params:
                    # a never-touched graph param holding its default is
                    # part of THIS trace (the trace is keyed on it)
                    return float(literal_params[ex.endpoint])
                if isinstance(ex, BinOp):
                    l, r = lit(ex.lhs), lit(ex.rhs)
                    if l is None or r is None or ex.op not in "+-*/":
                        return None
                    if ex.op == "/" and r == 0.0:
                        return None  # not a literal: leave it to runtime
                    return {"+": l + r, "-": l - r,
                            "*": l * r, "/": l / r if r else None}[ex.op]
                return None

            out = {}
            for ep in inst.node.INPUTS:
                # STREAM endpoints fed only by Const/untouched-param
                # expressions are literals too (a value->stream edge just
                # broadcasts the scalar) — e.g. the reference fm/pivot
                # voices feed Gain.gain (stream) from filter_env_amount
                if ep.kind not in (Kind.VALUE, Kind.STREAM):
                    continue
                edges = prog.edges_by_dst.get((name, ep.name), [])
                if not edges:
                    # unconnected: the default fill is the literal
                    out[ep.name] = float(ep.default or 0.0)
                    continue
                total, ok = None, True
                for e in edges:
                    if (e.kernel != EdgeKernel.NONE or e.is_feedback
                            or e.dst_index is not None):
                        ok = False
                        break
                    v = lit(e.source)
                    if v is None:
                        ok = False
                        break
                    total = v if total is None else total + v
                if ok:
                    out[ep.name] = total
            return out

        def _default_block(inst, ep, B):
            full = ((eff(inst.count),) if inst.count > 1 else ()) \
                + (B * inst.rate,) + _payload_shape(ep)
            return jnp.full(full, float(ep.default or 0.0), jnp.float32)

        # -------------------------------------------------------------- #
        def process_single(name: str) -> None:
            with explain.processing(name):
                _process_single_inner(name)

        def _process_single_inner(name: str) -> None:
            inst = ir.nodes[name]
            node = inst.node
            sr = prog.scaled_sr(inst)
            Bn = B * inst.rate
            ins = gather_block(name)
            evs = {ep.name: ev_bufs[f"{name}.{ep.name}"]
                   for ep in node.INPUTS if ep.kind == Kind.EVENT
                   and f"{name}.{ep.name}" in ev_bufs
                   and ev_bufs[f"{name}.{ep.name}"].capacity > 0}
            st = new_state[name]
            batched = None
            if inst.count > 1 and not evs and hasattr(
                    node, "process_block_batched"):
                # voice-batched fast path (e.g. one kernel across all
                # instances) — None falls back to vmap
                import inspect as _inspect
                sig = _inspect.signature(node.process_block_batched)
                kw = {}
                if "fanin_eps" in sig.parameters:
                    kw["fanin_eps"] = fanin_only.get(name, frozenset())
                if "const_ins" in sig.parameters:
                    kw["const_ins"] = const_eps(name)
                if "literal_ins" in sig.parameters:
                    kw["literal_ins"] = literal_eps(name)
                batched = node.process_block_batched(
                    st, ins, evs, sr, Bn, **kw)
            if batched is not None:
                if explain.active():
                    explain.note(path="batched",
                                 const_ins=sorted(const_eps(name)))
                st, outs = batched
            elif inst.count > 1:
                explain.note(path="vmap")
                import inspect as _inspect
                kwb = {}
                _sig = _inspect.signature(node.process_block).parameters
                if "const_ins" in _sig:
                    kwb["const_ins"] = const_eps(name)
                if "literal_ins" in _sig:
                    kwb["literal_ins"] = literal_eps(name)
                st, outs = jax.vmap(
                    lambda s, i, ev: node.process_block(
                        s, i, ev, sr, Bn, **kwb),
                    in_axes=(0, 0, 0))(st, ins, evs)
            else:
                if explain.active():
                    explain.note(path="block",
                                 const_ins=sorted(const_eps(name)))
                import inspect as _inspect
                kwb = {}
                _sig = _inspect.signature(node.process_block).parameters
                if "const_ins" in _sig:
                    kwb["const_ins"] = const_eps(name)
                if "literal_ins" in _sig:
                    kwb["literal_ins"] = literal_eps(name)
                st, outs = node.process_block(st, ins, evs, sr, Bn, **kwb)
            new_state[name] = st
            for k, v in outs.items():
                env[(name, k)] = v  # [C, B, ...] / [B, ...]
            # const-ness propagation: a stateless node may prove outputs
            # block-constant from its (const, literal) input sets
            cfn = getattr(node, "const_out_eps", None)
            if cfn is not None:
                ceps = cfn(const_eps(name), literal_eps(name))
                if ceps:
                    for epn in ceps:
                        const_outs.add((name, epn))
                    explain.note(const_outputs=sorted(ceps))

        for ci, comp in enumerate(comps):
            if len(comp) == 1 and not is_island(comp):
                process_single(comp[0])
            elif dissolve_plans[ci] is not None:
                # dissolved feedback island (all cycles pass min-delay
                # promises >= B): read delays -> acyclic rest -> write
                dels, rest_order = dissolve_plans[ci]
                for d in dels:
                    explain.note(node=d, path="dissolved_island_delay")
                stash = {}
                for d in dels:
                    node_d = ir.nodes[d].node
                    ins_p = gather_block(
                        d, only_eps=("delay_samples", "feedback"))
                    delayed, fbc = node_d.block_read(
                        new_state[d], ins_p, B,
                        literal_ins=literal_eps(d))
                    env[(d, "output")] = delayed
                    stash[d] = (delayed, fbc)
                for n in rest_order:
                    process_single(n)
                for d in dels:
                    node_d = ir.nodes[d].node
                    ins_x = gather_block(d, only_eps=("input",))
                    delayed, fbc = stash[d]
                    new_state[d] = node_d.block_write(
                        new_state[d], ins_x["input"], delayed, fbc, B)
            else:
                # ---- scan island: per-sample over the component -------
                island = comp
                for n in island:
                    explain.note(node=n, path="scan_island",
                                 island=sorted(island))
                island_set = set(island)
                # Node arrays inside scan islands shard fine: islands are
                # voice-independent along the array axis (per-voice
                # cycles scan locally per shard); only full fan-in sums
                # inside the island need a psum per tick.
                # Oversampled islands: a feedback cycle living entirely
                # inside a ``* N`` region scans at the inner rate (B·N
                # ticks), exactly the reference's inner loop running any
                # island node — including an AllowsFeedback Delay — per
                # inner tick (emit_frame.rs:114-176).  External inputs
                # arrive through their cross-rate boundary kernels (the
                # ext_inputs pre-pass below), event offsets are already
                # inner-scaled by the host prepass, and the __fb__ carry
                # advances one *inner* sample.  Cycles spanning the rate
                # boundary itself remain rejected (the reference's
                # taint/diamond restrictions, emit_node.rs:516-584).
                isl_rates = {ir.nodes[n].rate for n in island}
                if len(isl_rates) > 1:
                    raise NotImplementedError(
                        "feedback islands spanning a rate boundary are "
                        "unsupported (the reference similarly restricts "
                        "cross-rate feedback)")
                Bn_isl = B * isl_rates.pop()

                # inputs feeding the island from outside: evaluate whole
                # blocks now (fully fanout-normalized), slice per sample
                # inside the scan
                ext_inputs: Dict[Tuple[str, str, int], Any] = {}
                for name in island:
                    inst = ir.nodes[name]
                    for ep in inst.node.INPUTS:
                        if ep.kind in (Kind.EVENT, Kind.ASSET):
                            continue
                        for j, e in enumerate(prog.edges_by_dst.get(
                                (name, ep.name), [])):
                            src_nodes = {r.node for r in
                                         e.source.endpoints() if r.node}
                            if src_nodes & island_set:
                                continue  # internal edge
                            v = _edge_value(e, inst, ep, resolve_block,
                                            e.dst_index is not None)
                            taxis = 1 if (inst.count > 1
                                          and e.dst_index is None) else 0
                            ext_inputs[(name, ep.name, j)] = \
                                jnp.moveaxis(v, taxis, 0) if taxis else v

                island_state = {n: new_state[n] for n in island}
                fb_keys_here = [
                    (n, epn) for (n, epn) in prog.fb_keys if n in island_set]
                island_state["__fb__"] = {
                    f"{n}.{epn}": fb[f"{n}.{epn}"]
                    for (n, epn) in fb_keys_here}
                island_evs = {
                    f"{n}.{ep.name}": ev_bufs[f"{n}.{ep.name}"]
                    for n in island for ep in ir.nodes[n].node.INPUTS
                    if ep.kind == Kind.EVENT
                    and f"{n}.{ep.name}" in ev_bufs
                    and ev_bufs[f"{n}.{ep.name}"].capacity > 0}

                def island_step(carry, xs, island=island,
                                island_set=island_set,
                                fb_keys_here=fb_keys_here,
                                island_evs=island_evs):
                    ist, t, ext_t = carry[0], xs[0], xs[1]
                    env_t: Dict[Tuple[str, str], Any] = {}

                    def resolve_t(edge):
                        def r(ref: EndpointRef):
                            if ref.node == "":
                                return jnp.take(per_block[ref.endpoint],
                                                t, axis=0)
                            if ref.node in prog.host_set:
                                v = per_block[
                                    f"__host__{ref.node}.{ref.endpoint}"]
                                return jnp.take(v, t, axis=0)
                            key = (ref.node, ref.endpoint)
                            if ref.node not in island_set and key in env:
                                v = env[key]
                                taxis = 1 if node_count(ref.node) > 1 \
                                    else 0
                                return jnp.take(v, t, axis=taxis)
                            if key in env_t:
                                if edge is not None and edge.is_feedback \
                                        and edge.src_reads_state:
                                    return ist["__fb__"][
                                        f"{ref.node}.{ref.endpoint}"]
                                return env_t[key]
                            return ist["__fb__"][
                                f"{ref.node}.{ref.endpoint}"]
                        return r

                    new_ist = dict(ist)
                    for name in island:
                        inst = ir.nodes[name]
                        node = inst.node
                        sr = prog.scaled_sr(inst)
                        ins = {}
                        for ep in node.INPUTS:
                            if ep.kind in (Kind.EVENT, Kind.ASSET):
                                continue
                            edges = prog.edges_by_dst.get(
                                (name, ep.name), [])
                            val = None
                            for j, e in enumerate(edges):
                                if (name, ep.name, j) in ext_t:
                                    # pre-normalized whole-block value
                                    v = ext_t[(name, ep.name, j)]
                                else:
                                    v = prog.eval_expr(
                                        e.source, resolve_t(e))
                                    if e.fanout == Fanout.FAN_IN \
                                            and e.dst_index is None:
                                        v = jnp.sum(v, axis=0)
                                        if any(ir.nodes[r.node].count > 1
                                               for r in
                                               e.source.endpoints()
                                               if r.node in ir.nodes):
                                            v = _psum(v)
                                    elif e.fanout == Fanout.REPEAT \
                                            and e.dst_index is None:
                                        v = jnp.repeat(jnp.asarray(v),
                                                       e.factor, axis=0)
                                    elif e.fanout == Fanout.SEGMENT_SUM \
                                            and e.dst_index is None:
                                        v = prog._segment_sum(v, e.factor)
                                    if inst.count > 1 \
                                            and e.dst_index is None \
                                            and e.fanout in (
                                                Fanout.SCALAR,
                                                Fanout.BROADCAST):
                                        v = prog._broadcast_to_count(
                                            v, eff(inst.count), ep)
                                if e.dst_index is not None:
                                    base = val if val is not None else \
                                        _local_default(inst, ep)
                                    val = base.at[e.dst_index].set(v)
                                elif val is None:
                                    val = v
                                else:
                                    val = val + v
                            if val is None:
                                val = _local_default(inst, ep)
                            ins[ep.name] = val
                        st = new_ist[name]
                        for ep in node.INPUTS:
                            if ep.kind != Kind.EVENT:
                                continue
                            buf = island_evs.get(f"{name}.{ep.name}")
                            if buf is None:
                                continue
                            if inst.count > 1:
                                st = jax.vmap(
                                    lambda s, b, i: node.apply_events_at(
                                        s, ep.name, b, t, sr, i)
                                )(st, buf, ins)
                            else:
                                st = node.apply_events_at(
                                    st, ep.name, buf, t, sr, ins)
                        if inst.count > 1:
                            st, outs = jax.vmap(
                                lambda s, i: node.tick(s, i, sr))(st, ins)
                        else:
                            st, outs = node.tick(st, ins, sr)
                        new_ist[name] = st
                        for k, v in outs.items():
                            env_t[(name, k)] = v
                    nfb = dict(ist["__fb__"])
                    for (n, epn) in fb_keys_here:
                        nfb[f"{n}.{epn}"] = env_t[(n, epn)]
                    new_ist["__fb__"] = nfb
                    out_t = {f"{n}.{k}": v for (n, k), v in env_t.items()}
                    return (new_ist,), out_t

                # ext blocks already have time leading for the scan xs
                ext_scan = ext_inputs
                ts = jnp.arange(Bn_isl, dtype=jnp.int32)
                (island_state,), outs_t = jax.lax.scan(
                    island_step, (island_state,), (ts, ext_scan))
                for n in island:
                    new_state[n] = island_state[n]
                for key, v in island_state["__fb__"].items():
                    fb[key] = v
                for key, v in outs_t.items():
                    n, k = key.rsplit(".", 1)
                    # scan stacks time on axis 0; arrays need [C, B, ...]
                    if ir.nodes[n].count > 1:
                        v = jnp.moveaxis(v, 0, 1)
                    env[(n, k)] = v

        # refresh cross-island feedback carries: last sample of the block
        # (at the producing node's own rate)
        for (n, epn) in prog.fb_keys:
            v = env.get((n, epn))
            if v is None:
                continue
            taxis = 1 if node_count(n) > 1 else 0
            fb[f"{n}.{epn}"] = jax.lax.index_in_dim(
                v, B * ir.nodes[n].rate - 1, axis=taxis, keepdims=False)
        new_state["__fb__"] = fb

        # graph outputs
        outs = {}
        for o in ir.outputs:
            if o.kind == Kind.EVENT:
                continue  # event outputs are routed host-side
            expr = ir.output_edges.get(o.name)
            if expr is None:
                shape = (B,) if o.channels == 1 else (B, o.channels)
                outs[o.name] = jnp.zeros(shape, jnp.float32)
                continue
            v = prog.eval_expr(expr, resolve_block(None))
            want = 1 if o.channels == 1 else 2
            reduced = False
            while jnp.ndim(v) > want:
                v = jnp.sum(v, axis=0)
                reduced = True
            if reduced and any(ir.nodes[r.node].count > 1
                               for r in expr.endpoints()
                               if r.node in ir.nodes):
                v = _psum(v)  # instance-axis reduction spans the mesh
            outs[o.name] = v
        return new_state, outs

    return block_fn
