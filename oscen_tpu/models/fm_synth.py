"""FM synth voice — multi-operator FM with ADSR envelopes and routing.

Rebuild of the reference example's FMVoice graph
(/root/reference/examples/fm-synth/src/fm_voice.rs:6-157): three FmOperators
(OP3 → OP2 → OP1 carrier, with a crossfaded OP3→OP1 route), per-operator
ADSR envelopes, filter envelope with cutoff modulation, TPT filter, output
gain.  ``build_fm_synth`` wraps N voices behind MIDI + voice allocation.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import SampleRate, stream, value
from ..graph import explain
from ..graph.builder import Graph
from ..graph.node import Node
from ..nodes.basic import AddValue, Crossfade, FmOperator, Gain, Mixer
from ..nodes.envelope import AdsrEnvelope
from ..nodes.filters import TptFilter
from ..nodes.midi import MidiParser, MidiVoiceHandler
from ..nodes.voice_allocator import VoiceAllocator

TAU = 2.0 * math.pi


class FmOperatorChain(Node):
    """The FMVoice operator section fused into one node: op3 → route
    crossfade → op2 → mixer → op1 (fm_voice.rs connections :119-147), each
    an FM operator with self-feedback.  ``tick`` runs the per-sample
    chain step (ops/pallas/fm.py ``fm_chain_step``); event-free blocks
    with a kernel route scan the same step for all voices in ONE
    lane-parallel kernel instead of three sequential per-operator
    recurrences."""

    INPUTS = (value("base_freq", 440.0),
              value("op3_ratio", 3.0), value("op2_ratio", 2.0),
              value("op1_ratio", 1.0),
              value("op3_level", 0.5), value("op2_level", 0.5),
              value("op1_level", 1.0),
              value("op3_feedback", 0.0), value("op2_feedback", 0.0),
              value("op1_feedback", 0.0),
              value("route", 0.0),
              stream("env3", 1.0), stream("env2", 1.0),
              stream("env1", 1.0))
    OUTPUTS = (stream("output"),)

    def init_state(self, sr: SampleRate):
        return {"phases": jnp.zeros((3,), jnp.float32),
                "prevs": jnp.zeros((3,), jnp.float32)}

    def tick(self, state, ins, sr):
        from ..ops.pallas.fm import fm_chain_step
        f = ins["base_freq"]
        # sin·(env·lvl): the block path folds the levels into the
        # envelope streams the same way, keeping parity bit-exact
        xs = tuple(f * ins[f"op{i}_ratio"] / sr.hz for i in (3, 2, 1)) \
            + tuple(ins[f"env{i}"] * ins[f"op{i}_level"] for i in (3, 2, 1)) \
            + tuple(ins[f"op{i}_feedback"] for i in (3, 2, 1)) \
            + (jnp.clip(ins["route"], 0.0, 1.0),)
        carry, y1 = fm_chain_step(
            tuple(state["phases"]) + tuple(state["prevs"]), xs)
        return ({"phases": jnp.stack(carry[:3]),
                 "prevs": jnp.stack(carry[3:])},
                {"output": y1})

    FB_EPS = ("op3_feedback", "op2_feedback", "op1_feedback")

    def process_block_batched(self, state, ins, events, sr, block_len,
                              const_ins=frozenset(), literal_ins=None):
        from ..ops.pallas.util import pallas_mode
        if not pallas_mode()[0]:
            return None
        from ..ops.pallas.fm import fm_chain3_scan

        # dt must be per-sample WHEN the voice allocator retunes
        # base_freq mid-block at note-on (this node sees no gate event
        # that would force the fallback path).  In event-free blocks the
        # handler stages frequency as [1] and the compiler marks
        # base_freq block-constant (const_ins): dt collapses to [3,1,C]
        # rows and the kernel hoists its per-sample dt reads.
        # Levels/feedback/route are UI params, hoisted from sample 0.
        dt_const = {"base_freq", "op3_ratio", "op2_ratio",
                    "op1_ratio"} <= const_ins
        tdt = (lambda v: jnp.moveaxis(v[:, :1], 0, 1)) if dt_const \
            else (lambda v: jnp.moveaxis(v, 0, 1))
        dt = jnp.stack([
            tdt(ins["base_freq"] * ins[f"op{i}_ratio"])
            for i in (3, 2, 1)]) / sr.hz        # [3, B, C] or [3, 1, C]
        lvl = jnp.stack([ins[f"op{i}_level"][:, 0] for i in (3, 2, 1)])
        fb = jnp.stack([ins[f"op{i}_feedback"][:, 0] for i in (3, 2, 1)])
        mix = jnp.clip(ins["route"][:, 0], 0.0, 1.0)
        # Feedback params that are trace-time literals (unconnected
        # defaults / flattened-subgraph Consts — the reference default is
        # 0.0) resolve the zero-feedback branch at TRACE time: only the
        # selected branch is compiled, no runtime cond.  Live (staged)
        # feedback params keep the runtime lax.cond.
        fb_static = None
        lits = literal_ins or {}
        if all(ep in lits for ep in self.FB_EPS):
            fb_static = all(lits[ep] == 0.0 for ep in self.FB_EPS)
        eligible = dt.shape[1] == 1
        explain.note(kernel="fm_chain3", const_dt=dt_const,
                     fast_path="zero_feedback", eligible=eligible,
                     engaged=(False if not eligible else
                              fb_static if fb_static is not None
                              else None),
                     predicate="all_zero" if (eligible and
                                              fb_static is None) else None,
                     predicate_eps=self.FB_EPS)
        tbv = lambda v: jnp.moveaxis(v, 0, 1)
        y, ph, pv = fm_chain3_scan(
            jnp.moveaxis(state["phases"], 0, 1),
            jnp.moveaxis(state["prevs"], 0, 1),
            dt, lvl, fb, mix,
            tbv(ins["env3"]), tbv(ins["env2"]), tbv(ins["env1"]),
            fb_static=fb_static)
        return ({"phases": jnp.moveaxis(ph, 0, 1),
                 "prevs": jnp.moveaxis(pv, 0, 1)},
                {"output": jnp.moveaxis(y, 0, 1)})

OP_DEFAULTS = {
    "op3": dict(ratio=3.0, level=0.5, feedback=0.0, attack=0.01,
                decay=0.1, sustain=0.7, release=0.3),
    "op2": dict(ratio=2.0, level=0.5, feedback=0.0, attack=0.01,
                decay=0.1, sustain=0.7, release=0.3),
    "op1": dict(ratio=1.0, attack=0.01, decay=0.2, sustain=0.8,
                release=0.5),
}


def build_fm_voice(fused: bool = False) -> Graph:
    """``fused=True`` collapses the operator section into the
    FmOperatorChain node (one lane-parallel kernel per block);
    ``fused=False`` mirrors the reference graph structure node for node.
    Both are equivalence-tested."""
    if fused:
        return _build_fm_voice_fused()
    g = Graph("FMVoice")
    g.input("frequency", "value", default=440.0)
    g.input("gate", "event")
    for op, d in OP_DEFAULTS.items():
        for k, v in d.items():
            g.input(f"{op}_{k}", "value", default=v)
    g.input("route", "value", default=0.0)
    g.input("filter_cutoff", "value", default=2000.0)
    g.input("filter_resonance", "value", default=0.707)
    for k, v in dict(attack=0.01, decay=0.2, sustain=0.5,
                     release=0.3).items():
        g.input(f"filter_{k}", "value", default=v)
    g.input("filter_env_amount", "value", default=0.0)
    g.output("audio_out", "stream")

    env3 = g.add("env3", AdsrEnvelope(0.01, 0.1, 0.7, 0.3))
    env2 = g.add("env2", AdsrEnvelope(0.01, 0.1, 0.7, 0.3))
    env1 = g.add("env1", AdsrEnvelope(0.01, 0.2, 0.8, 0.5))
    env_f = g.add("env_filter", AdsrEnvelope(0.01, 0.2, 0.5, 0.3))
    f_gain = g.add("filter_env_gain", Gain(0.0))
    cutoff_mod = g.add("cutoff_mod", AddValue(2000.0))
    op3 = g.add("op3_osc", FmOperator())
    op2 = g.add("op2_osc", FmOperator())
    op1 = g.add("op1_osc", FmOperator())
    route = g.add("op3_route", Crossfade())
    mix1 = g.add("op1_mod_mixer", Mixer())
    filt = g.add("filter", TptFilter(2000.0, 0.707))
    out_g = g.add("output_gain", Gain(0.3))

    # gate to all envelopes; per-operator envelope parameters
    for env in (env3, env2, env1):
        g.connect("gate", env.gate)
    g.connect("gate", env_f.gate)
    for env_name, op in (("env3", "op3"), ("env2", "op2"), ("env1", "op1")):
        for k in ("attack", "decay", "sustain", "release"):
            g.connect(f"{op}_{k}", f"{env_name}.{k}")
    for k in ("attack", "decay", "sustain", "release"):
        g.connect(f"filter_{k}", f"env_filter.{k}")

    # filter envelope modulation: env -> gain(amount) -> add(cutoff)
    g.connect(env_f.output, f_gain.input)
    g.connect("filter_env_amount", f_gain.gain)
    g.connect(f_gain.output, cutoff_mod.input)
    g.connect("filter_cutoff", cutoff_mod.value)
    g.connect(cutoff_mod.output, filt.cutoff)

    # OP3 (top modulator)
    g.connect("frequency", op3.base_freq)
    g.connect("op3_ratio", op3.ratio)
    g.connect("op3_feedback", op3.feedback)
    g.connect(env3.output, op3.envelope)
    g.connect("op3_level", op3.level)

    # route crossfade: OP3 -> OP2 (a) or OP1 (b)
    g.connect(op3.output, route.input)
    g.connect("route", route.mix)
    g.connect(route.output_a, op2.phase_mod)

    # OP2 (middle modulator)
    g.connect("frequency", op2.base_freq)
    g.connect("op2_ratio", op2.ratio)
    g.connect("op2_feedback", op2.feedback)
    g.connect(env2.output, op2.envelope)
    g.connect("op2_level", op2.level)

    # mix OP2 + routed OP3 into OP1's phase mod
    g.connect(op2.output, mix1.input_a)
    g.connect(route.output_b, mix1.input_b)
    g.connect(mix1.output, op1.phase_mod)

    # OP1 (carrier)
    g.connect("frequency", op1.base_freq)
    g.connect("op1_ratio", op1.ratio)
    g.connect(env1.output, op1.envelope)
    g.connect(op1.output, filt.input)

    g.connect("filter_resonance", filt.q)
    g.connect(filt.output, out_g.input)
    g.connect(out_g.output, "audio_out")
    return g


def _build_fm_voice_fused() -> Graph:
    g = Graph("FMVoiceFused")
    g.input("frequency", "value", default=440.0)
    g.input("gate", "event")
    for op, d in OP_DEFAULTS.items():
        for k, v in d.items():
            g.input(f"{op}_{k}", "value", default=v)
    g.input("route", "value", default=0.0)
    g.input("filter_cutoff", "value", default=2000.0)
    g.input("filter_resonance", "value", default=0.707)
    for k, v in dict(attack=0.01, decay=0.2, sustain=0.5,
                     release=0.3).items():
        g.input(f"filter_{k}", "value", default=v)
    g.input("filter_env_amount", "value", default=0.0)
    g.output("audio_out", "stream")

    # the four per-voice envelopes horizontally fused into one node
    # (PERF.md: "horizontal fusion of the four per-voice envelope node
    # arrays into one 4·V-lane evaluation")
    from ..nodes.envelope import AdsrBank
    envs = g.add("envs", AdsrBank([
        ("op3", 0.01, 0.1, 0.7, 0.3),
        ("op2", 0.01, 0.1, 0.7, 0.3),
        ("op1", 0.01, 0.2, 0.8, 0.5),
        ("filt", 0.01, 0.2, 0.5, 0.3),
    ]))
    f_gain = g.add("filter_env_gain", Gain(0.0))
    cutoff_mod = g.add("cutoff_mod", AddValue(2000.0))
    chain = g.add("ops", FmOperatorChain())
    filt = g.add("filter", TptFilter(2000.0, 0.707))
    out_g = g.add("output_gain", Gain(0.3))

    g.connect("gate", envs.gate)
    for op in ("op3", "op2", "op1"):
        for k in ("attack", "decay", "sustain", "release"):
            g.connect(f"{op}_{k}", f"envs.{op}_{k}")
    for k in ("attack", "decay", "sustain", "release"):
        g.connect(f"filter_{k}", f"envs.filt_{k}")

    g.connect(envs.filt, f_gain.input)
    g.connect("filter_env_amount", f_gain.gain)
    g.connect(f_gain.output, cutoff_mod.input)
    g.connect("filter_cutoff", cutoff_mod.value)
    g.connect(cutoff_mod.output, filt.cutoff)

    g.connect("frequency", chain.base_freq)
    for i in (3, 2):
        g.connect(f"op{i}_ratio", f"ops.op{i}_ratio")
        g.connect(f"op{i}_level", f"ops.op{i}_level")
        g.connect(f"op{i}_feedback", f"ops.op{i}_feedback")
    g.connect("op1_ratio", chain.op1_ratio)
    g.connect("route", chain.route)
    g.connect(envs.op3, chain.env3)
    g.connect(envs.op2, chain.env2)
    g.connect(envs.op1, chain.env1)

    g.connect(chain.output, filt.input)
    g.connect("filter_resonance", filt.q)
    g.connect(filt.output, out_g.input)
    g.connect(out_g.output, "audio_out")
    return g


def build_fm_synth(num_voices: int = 8, fused: bool = True) -> Graph:
    """Polyphonic FM synth: MIDI → allocator → N FMVoice subgraphs →
    fan-in mix (the reference app runs 8 voices)."""
    g = Graph(f"FMSynth{num_voices}")
    g.input("midi_in", "event")
    g.input("route", "value", default=0.0)
    g.input("filter_cutoff", "value", default=2000.0)
    g.output("audio_out", "stream")

    parser = g.add("parser", MidiParser())
    alloc = g.add("alloc", VoiceAllocator(num_voices))
    handlers = g.add("handlers", MidiVoiceHandler(), count=num_voices)
    voices = g.add("voices", build_fm_voice(fused=fused),
                   count=num_voices)

    g.connect("midi_in", parser.midi_in)
    g.connect(parser.note_on, alloc.note_on)
    g.connect(parser.note_off, alloc.note_off)
    g.connect(alloc.voices, handlers.note_on)
    g.connect(alloc.voices, handlers.note_off)
    g.connect(handlers.frequency, voices.frequency)
    g.connect(handlers.gate, voices.gate)
    g.connect("route", voices.route)
    g.connect("filter_cutoff", voices.filter_cutoff)
    g.connect(voices.audio_out, "audio_out")
    return g
