"""Stateless / near-stateless utility nodes.

Counterparts of the reference's small nodes: Gain (gain/mod.rs), Value
(value.rs), AudioInput (graph/audio_input.rs), plus the example-local
HardClip (examples/oversampled-saturator/src/main.rs:31-62), Mixer,
Crossfade, AddValue (examples/fm-synth/src/nodes/), Tremolo
(examples/electric-piano/src/tremolo.rs) and FmOperator
(examples/fm-synth/src/nodes/fm_operator.rs).

Stateless nodes vectorize trivially over the block (the default scan is
bypassed by a direct broadcast implementation).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..core.types import SampleRate, stream, value
from ..graph.node import Node

TAU = 2.0 * math.pi


class _StatelessNode(Node):
    """Nodes whose tick is a pure function of inputs: the block impl simply
    applies the tick math to whole ``[B]`` arrays."""

    def init_state(self, sr: SampleRate):
        return {}

    def process_block(self, state, ins, events, sr, block_len):
        return self.tick(state, ins, sr)

    def const_out_eps(self, const_ins, literal_ins):
        """Const-output propagation (graph/block_mode.py const_outs): a
        pure function of block-constant inputs is block-constant."""
        from ..core.types import Kind as _K
        if all(e.name in const_ins for e in self.INPUTS
               if e.kind not in (_K.EVENT, _K.ASSET)):
            return tuple(o.name for o in self.OUTPUTS)
        return ()


class Gain(_StatelessNode):
    """``out = in * gain`` (reference gain/mod.rs)."""

    INPUTS = (stream("input", 0.0), stream("gain", 1.0))
    OUTPUTS = (stream("output"),)

    def __init__(self, initial_gain: float = 1.0):
        self.INPUTS = (stream("input", 0.0), stream("gain", float(initial_gain)))

    def tick(self, state, ins, sr):
        return state, {"output": ins["input"] * ins["gain"]}

    def const_out_eps(self, const_ins, literal_ins):
        """With a LITERAL 0.0 gain the output is identically zero
        regardless of the stream input (the reference fm/pivot voices
        feed filter_env_gain a 0.0-default amount — the whole envelope
        modulation path folds away until the param is first set)."""
        if literal_ins.get("gain") == 0.0:
            return ("output",)
        return super().const_out_eps(const_ins, literal_ins)

    def process_block(self, state, ins, events, sr, block_len,
                      literal_ins=None):
        if literal_ins and literal_ins.get("gain") == 0.0:
            # in·0 ≡ 0 (inputs finite by construction; the same
            # trace-time-zero judgment as the FM chain's literal-0.0
            # feedback / MulAdd's zero gain)
            shape = jnp.broadcast_shapes(jnp.shape(ins["input"]),
                                         jnp.shape(ins["gain"]))
            return state, {"output": jnp.zeros(shape, jnp.float32)}
        return self.tick(state, ins, sr)


class Vca(_StatelessNode):
    """Voltage-controlled amplifier: ``out = in * control`` (stream ×
    stream), used to apply envelope modulation to audio signals
    (reference examples/pivot/src/vca.rs:31-36)."""

    INPUTS = (stream("input", 0.0), stream("control", 1.0))
    OUTPUTS = (stream("output"),)

    def tick(self, state, ins, sr):
        return state, {"output": ins["input"] * ins["control"]}


class Value(_StatelessNode):
    """Pass-through parameter holder (reference value.rs)."""

    INPUTS = (value("input", 0.0),)
    OUTPUTS = (value("output"),)

    def __init__(self, initial_value: float = 0.0):
        self.INPUTS = (value("input", float(initial_value)),)

    def tick(self, state, ins, sr):
        return state, {"output": ins["input"]}


class AudioInput(_StatelessNode):
    """value→stream bridge (reference graph/audio_input.rs)."""

    INPUTS = (value("input_value", 0.0),)
    OUTPUTS = (stream("output"),)

    def tick(self, state, ins, sr):
        return state, {"output": ins["input_value"]}


class HardClip(_StatelessNode):
    """Drive-then-clip nonlinearity (reference oversampled-saturator
    main.rs:31-62): ``out = clamp(in * 1.5, -0.7, 0.7)``."""

    INPUTS = (stream("input", 0.0),)
    OUTPUTS = (stream("output"),)

    def tick(self, state, ins, sr):
        return state, {"output": jnp.clip(ins["input"] * 1.5, -0.7, 0.7)}


class Mixer(_StatelessNode):
    """Two-input adder (reference fm-synth nodes/mixer.rs)."""

    INPUTS = (stream("input_a", 0.0), stream("input_b", 0.0))
    OUTPUTS = (stream("output"),)

    def tick(self, state, ins, sr):
        return state, {"output": ins["input_a"] + ins["input_b"]}


class Crossfade(_StatelessNode):
    """Splits input between two outputs by ``mix`` (fm-synth
    nodes/crossfade.rs): a=in*(1-mix), b=in*mix."""

    INPUTS = (stream("input", 0.0), value("mix", 0.0))
    OUTPUTS = (stream("output_a"), stream("output_b"))

    def tick(self, state, ins, sr):
        mix = jnp.clip(ins["mix"], 0.0, 1.0)
        return state, {"output_a": ins["input"] * (1.0 - mix),
                       "output_b": ins["input"] * mix}


class AddValue(_StatelessNode):
    """``out = in + value`` (fm-synth nodes/add_value.rs)."""

    INPUTS = (stream("input", 0.0), value("value", 0.0))
    OUTPUTS = (stream("output"),)

    def __init__(self, v: float = 0.0):
        self.INPUTS = (stream("input", 0.0), value("value", float(v)))

    def tick(self, state, ins, sr):
        return state, {"output": ins["input"] + ins["value"]}


class MulAdd(_StatelessNode):
    """``out = in·gain + value`` — a Gain→AddValue pair fused into one
    node (identical fp ops/order, one fewer [C, B] intermediate; used by
    the fused pivot voice's filter-env cutoff modulation,
    pivot_voice.rs:126-130, which composes Gain + AddValue)."""

    INPUTS = (stream("input", 0.0), value("gain", 1.0),
              value("value", 0.0))
    OUTPUTS = (stream("output"),)

    def __init__(self, gain: float = 1.0, v: float = 0.0):
        self.INPUTS = (stream("input", 0.0), value("gain", float(gain)),
                       value("value", float(v)))

    def tick(self, state, ins, sr):
        return state, {"output": ins["input"] * ins["gain"]
                       + ins["value"]}

    def const_out_eps(self, const_ins, literal_ins):
        """Block-constant-output declaration (graph/block_mode.py
        const_outs): with a LITERAL 0.0 gain the stream input is
        multiplied out entirely, so the output is constant whenever
        ``value`` is; with every input constant it trivially is
        (the _StatelessNode base rule)."""
        if literal_ins.get("gain") == 0.0 and "value" in const_ins:
            return ("output",)
        return super().const_out_eps(const_ins, literal_ins)

    def process_block(self, state, ins, events, sr, block_len,
                      literal_ins=None):
        if literal_ins and literal_ins.get("gain") == 0.0:
            # out = in·0 + value ≡ value: the modulation path compiles
            # away (its producer becomes dead code XLA eliminates).  The
            # trace-time-zero judgment matches the FM chain's literal-0.0
            # feedback specialization: modulation sources here are finite
            # by construction, so dropping the ·0 term is exact.
            v = ins["value"]
            shape = jnp.broadcast_shapes(jnp.shape(ins["input"]),
                                         jnp.shape(v))
            return state, {"output": jnp.broadcast_to(v, shape)}
        return self.tick(state, ins, sr)


class Tremolo(Node):
    """Mono→stereo constant-power pan LFO (reference
    examples/electric-piano/src/tremolo.rs:8-60).

    The LFO phase uses an *anchored* representation — ``phase(t) =
    wrap(anchor + dt·k)`` with the integer tick count ``k`` carried and
    the anchor rebased only when the rate changes (or at a fixed absolute
    K_REBASE to keep ``dt·k`` exact in f32).  The block path evaluates the
    same formula vectorized, so block mode is bit-identical to the
    per-sample tick AND block-size invariant, with no sequential scan in
    the common (rate-constant) case — this node sits on the flagship's
    single-lane mixdown path.
    """

    INPUTS = (stream("input", 0.0), value("rate", 5.0), value("depth", 0.5))
    OUTPUTS = (stream("output", channels=2),)

    K_REBASE = 1 << 20  # dt·k stays exact well below 2^24

    def init_state(self, sr: SampleRate):
        return {"anchor": jnp.float32(0.0),
                "k": jnp.int32(0),
                "dt_last": jnp.float32(0.0)}

    @staticmethod
    def _pan(x, phase, depth):
        lfo = jnp.sin(phase * TAU)
        pan = 0.5 + lfo * (depth / 3.0)
        return jnp.stack([x * pan, x * (1.0 - pan)], axis=-1)

    @staticmethod
    def _wrap(p):
        return p - jnp.floor(p)

    def tick(self, state, ins, sr):
        dt = ins["rate"] / sr.hz
        anchor, k = state["anchor"], state["k"]
        changed = jnp.logical_and(dt != state["dt_last"], k > 0)
        anchor = jnp.where(changed,
                           self._wrap(anchor + state["dt_last"]
                                      * k.astype(jnp.float32)), anchor)
        k = jnp.where(changed, 0, k)
        phase = self._wrap(anchor + dt * k.astype(jnp.float32))
        out = self._pan(ins["input"], phase, ins["depth"])
        k = k + 1
        rebase = k >= self.K_REBASE
        anchor = jnp.where(rebase,
                           self._wrap(anchor + dt * float(self.K_REBASE)),
                           anchor)
        k = jnp.where(rebase, k - self.K_REBASE, k)
        return ({"anchor": anchor, "k": k, "dt_last": dt},
                {"output": out})

    def process_block(self, state, ins, events, sr, block_len):
        B = block_len
        dt = ins["rate"] / sr.hz  # [B]
        K = float(self.K_REBASE)

        def fast_from(anchor, k0, dt0):
            ks = k0.astype(jnp.float32) + jnp.arange(B, dtype=jnp.float32)
            a2 = self._wrap(anchor + dt0 * K)
            phase = jnp.where(ks < K,
                              self._wrap(anchor + dt0 * ks),
                              self._wrap(a2 + dt0 * (ks - K)))
            k_end = k0 + B
            reb = k_end >= self.K_REBASE
            return (phase,
                    jnp.where(reb, a2, anchor),
                    jnp.where(reb, k_end - self.K_REBASE, k_end),
                    dt0)

        def pan_out(x, phase, depth):
            lfo = jnp.sin(phase * TAU)
            pan = 0.5 + lfo * (depth / 3.0)
            return jnp.stack([x * pan, x * (1.0 - pan)], axis=-1)

        same = jnp.all(dt == state["dt_last"])

        def slow_phase():
            def step(carry, dt_t):
                anchor, k, dt_last = carry
                changed = jnp.logical_and(dt_t != dt_last, k > 0)
                anchor = jnp.where(
                    changed,
                    self._wrap(anchor + dt_last * k.astype(jnp.float32)),
                    anchor)
                k = jnp.where(changed, 0, k)
                phase = self._wrap(anchor + dt_t * k.astype(jnp.float32))
                k = k + 1
                rebase = k >= self.K_REBASE
                anchor = jnp.where(rebase, self._wrap(anchor + dt_t * K),
                                   anchor)
                k = jnp.where(rebase, k - self.K_REBASE, k)
                return (anchor, k, dt_t), phase
            (anchor, k, dt_last), phase = jax.lax.scan(
                step, (state["anchor"], state["k"], state["dt_last"]), dt)
            return phase, anchor, k, dt_last

        # the pan is computed INSIDE each branch: the output array is
        # what crosses the cond boundary, while the [B] phase array stays
        # fused into its branch (same ops, same order — bit-exact)
        def fast(_):
            phase, anchor, k, dt_last = fast_from(
                state["anchor"], state["k"], dt[0])
            return (pan_out(ins["input"], phase, ins["depth"]),
                    anchor, k, dt_last)

        def slow(_):
            phase, anchor, k, dt_last = slow_phase()
            return (pan_out(ins["input"], phase, ins["depth"]),
                    anchor, k, dt_last)

        out, anchor, k, dt_last = jax.lax.cond(same, fast, slow,
                                               operand=None)
        return ({"anchor": anchor, "k": k, "dt_last": dt_last},
                {"output": out})


def fm_operator_step(carry, xs):
    """One FM operator tick on lane rows (reference op order,
    fm_operator.rs:57-77): ``dt`` is ``base_freq * ratio / sr``."""
    from ..ops.fastmath import sin_turns
    phase, prev = carry
    dt, pm, fb, env, lvl = xs
    feedback_mod = prev * fb
    total_pm = pm + feedback_mod
    out = sin_turns(phase + total_pm) * env * lvl
    phase = phase + dt
    return (phase - jnp.trunc(phase), out), out  # Rust .fract()


class FmOperator(Node):
    """Sine operator with phase modulation and self-feedback (reference
    examples/fm-synth/src/nodes/fm_operator.rs).

    The self-feedback term (``prev_output * feedback``) is a one-sample
    nonlinear recurrence: the block path scans :func:`fm_operator_step`
    (one lane-parallel kernel for all voices where a kernel route
    exists).
    """

    INPUTS = (value("base_freq", 440.0), value("ratio", 1.0),
              stream("phase_mod", 0.0), value("feedback", 0.0),
              stream("envelope", 1.0), value("level", 1.0))
    OUTPUTS = (stream("output"),)

    def init_state(self, sr: SampleRate):
        return {"phase": jnp.float32(0.0), "prev_output": jnp.float32(0.0)}

    def tick(self, state, ins, sr):
        frequency = ins["base_freq"] * ins["ratio"]
        (phase, prev), out = fm_operator_step(
            (state["phase"], state["prev_output"]),
            (frequency / sr.hz, ins["phase_mod"], ins["feedback"],
             ins["envelope"], ins["level"]))
        return ({"phase": phase, "prev_output": prev}, {"output": out})

    def process_block(self, state, ins, events, sr, block_len):
        """Scalar-instance block path: the same lane scan as the
        voice-batched path, one lane wide."""
        from ..ops.pallas.util import pallas_mode
        if not pallas_mode()[0]:
            return super().process_block(state, ins, events, sr,
                                         block_len)
        st1 = {k: jnp.reshape(jnp.asarray(v), (1,))
               for k, v in state.items()}
        ins1 = {k: jnp.broadcast_to(jnp.asarray(v), (block_len,))[None]
                for k, v in ins.items()}
        st2, outs = self.process_block_batched(st1, ins1, events, sr,
                                               block_len)
        return ({k: jnp.reshape(v, ()) for k, v in st2.items()},
                {k: v[0] for k, v in outs.items()})

    def process_block_batched(self, state, ins, events, sr, block_len):
        """All voices through one lane-parallel kernel
        (:func:`fm_operator_step`); without a kernel route the compiler
        vmaps the per-sample scan instead."""
        from ..ops.pallas.recurrence import lane_scan
        from ..ops.pallas.util import pallas_mode
        if not pallas_mode()[0]:
            return None
        dt = ins["base_freq"] * ins["ratio"] / sr.hz  # [C, B]
        tbv = lambda v: jnp.moveaxis(v, 0, 1)  # [C, B] -> [B, C]
        (phase, prev), y = lane_scan(
            fm_operator_step, (state["phase"], state["prev_output"]),
            (tbv(dt), tbv(ins["phase_mod"]), tbv(ins["feedback"]),
             tbv(ins["envelope"]), tbv(ins["level"])))
        return ({"phase": phase, "prev_output": prev},
                {"output": jnp.moveaxis(y, 0, 1)})
