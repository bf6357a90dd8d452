"""Pivot — the reference's flagship 8-voice FM synth app.

Rebuild of /root/reference/examples/pivot/: a 3-operator FM voice with a
routing crossfade (`pivot_voice.rs:1-174`), wrapped in MIDI + LRU voice
allocation (`main.rs:59-168`).

Structurally the pivot voice differs from the fm-synth voice
(`examples/fm-synth/src/fm_voice.rs`) in where envelopes apply: pivot's
FmOperator (`examples/pivot/src/fm_operator.rs:48-69`) has no
envelope/level inputs — the raw sine feeds the operator's own
self-feedback, and envelope × level are applied *outside* through Vca
(stream × stream, `vca.rs:31-36`) and Gain nodes before the routing
crossfade.  This changes both the feedback timbre and the modulation
depth curve, so it is modeled as its own graph, not a parameterization of
FMVoice.

Signal flow per voice (pivot_voice.rs:94-173):

    op3 ──▶ vca(env3) ──▶ gain(op3_level) ──▶ crossfade(route)
                                              │ a → op2.phase_mod
                                              │ b ─┐
    op2 ──▶ vca(env2) ──▶ gain(op2_level) ────────┼─▶ mixer ─▶ op1.phase_mod
                                                  ┘
    op1 ──▶ vca(env1) ──▶ TptFilter(cutoff + env_filter·amount) ─▶ gain(0.3)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import SampleRate, stream, value
from ..graph import explain
from ..graph.builder import Graph
from ..graph.node import Node
from ..nodes.basic import (AddValue, Crossfade, FmOperator, Gain, Mixer,
                           MulAdd, Vca)
from ..nodes.envelope import AdsrEnvelope
from ..nodes.filters import TptFilter
from ..nodes.midi import MidiParser, MidiVoiceHandler
from ..nodes.voice_allocator import VoiceAllocator

# pivot_voice.rs:14-52 input defaults
OP_DEFAULTS = {
    "op3": dict(ratio=3.0, level=0.5, feedback=0.0, attack=0.01,
                decay=0.1, sustain=0.7, release=0.3),
    "op2": dict(ratio=2.0, level=0.5, feedback=0.0, attack=0.01,
                decay=0.1, sustain=0.7, release=0.3),
    "op1": dict(ratio=1.0, attack=0.01, decay=0.2, sustain=0.8,
                release=0.5),
}
FILTER_DEFAULTS = dict(attack=0.01, decay=0.2, sustain=0.5, release=0.3)


class PivotOperatorChain(Node):
    """The pivot operator section fused into one node: op3 → vca(env3) →
    gain(lvl3) → route crossfade → op2 → vca(env2) → gain(lvl2) → mixer →
    op1 → vca(env1)  (pivot_voice.rs:94-165, pre-filter).

    Unlike the fm-synth chain, the RAW sine feeds each operator's own
    self-feedback (pivot's FmOperator has no envelope/level inputs —
    examples/pivot/src/fm_operator.rs:48-69); the enveloped/leveled
    signal drives the modulation routing.  ``tick`` runs the per-sample
    chain step (ops/pallas/fm.py ``pivot_chain_step``); event-free blocks
    with a kernel route scan the same step for all voices in ONE
    lane-parallel kernel.
    """

    INPUTS = (value("base_freq", 440.0),
              value("op3_ratio", 3.0), value("op2_ratio", 2.0),
              value("op1_ratio", 1.0),
              value("op3_level", 0.5), value("op2_level", 0.5),
              value("op3_feedback", 0.0), value("op2_feedback", 0.0),
              value("op1_feedback", 0.0),
              value("route", 0.0),
              stream("env3", 1.0), stream("env2", 1.0),
              stream("env1", 1.0))
    OUTPUTS = (stream("output"),)

    def init_state(self, sr: SampleRate):
        return {"phases": jnp.zeros((3,), jnp.float32),
                "prevs": jnp.zeros((3,), jnp.float32)}  # RAW sine history

    def tick(self, state, ins, sr):
        from ..ops.pallas.fm import pivot_chain_step
        f = ins["base_freq"]
        xs = tuple(f * ins[f"op{i}_ratio"] / sr.hz for i in (3, 2, 1)) \
            + (ins["env3"] * ins["op3_level"], ins["env2"] * ins["op2_level"],
               ins["env1"] * 1.0) \
            + tuple(ins[f"op{i}_feedback"] for i in (3, 2, 1)) \
            + (jnp.clip(ins["route"], 0.0, 1.0),)
        carry, out = pivot_chain_step(
            tuple(state["phases"]) + tuple(state["prevs"]), xs)
        return ({"phases": jnp.stack(carry[:3]),
                 "prevs": jnp.stack(carry[3:])},      # RAW sine history
                {"output": out})

    FB_EPS = ("op3_feedback", "op2_feedback", "op1_feedback")

    def process_block_batched(self, state, ins, events, sr, block_len,
                              const_ins=frozenset(), literal_ins=None):
        from ..ops.pallas.util import pallas_mode
        if not pallas_mode()[0]:
            return None
        from ..ops.pallas.fm import pivot_chain3_scan

        # block-constant pitch (no note-on this block) collapses dt to
        # [3, 1, C] rows — see FmOperatorChain.process_block_batched
        dt_const = {"base_freq", "op3_ratio", "op2_ratio",
                    "op1_ratio"} <= const_ins
        tdt = (lambda v: jnp.moveaxis(v[:, :1], 0, 1)) if dt_const \
            else (lambda v: jnp.moveaxis(v, 0, 1))
        dt = jnp.stack([
            tdt(ins["base_freq"] * ins[f"op{i}_ratio"])
            for i in (3, 2, 1)]) / sr.hz        # [3, B, C] or [3, 1, C]
        lvl = jnp.stack([ins["op3_level"][:, 0], ins["op2_level"][:, 0],
                         jnp.ones_like(ins["op2_level"][:, 0])])
        fb = jnp.stack([ins[f"op{i}_feedback"][:, 0] for i in (3, 2, 1)])
        mix = jnp.clip(ins["route"][:, 0], 0.0, 1.0)
        # trace-time zero-feedback resolution — see FmOperatorChain
        fb_static = None
        lits = literal_ins or {}
        if all(ep in lits for ep in self.FB_EPS):
            fb_static = all(lits[ep] == 0.0 for ep in self.FB_EPS)
        eligible = dt.shape[1] == 1
        explain.note(kernel="pivot_chain3", const_dt=dt_const,
                     fast_path="zero_feedback", eligible=eligible,
                     engaged=(False if not eligible else
                              fb_static if fb_static is not None
                              else None),
                     predicate="all_zero" if (eligible and
                                              fb_static is None) else None,
                     predicate_eps=self.FB_EPS)
        tbv = lambda v: jnp.moveaxis(v, 0, 1)
        y, ph, pv = pivot_chain3_scan(
            jnp.moveaxis(state["phases"], 0, 1),
            jnp.moveaxis(state["prevs"], 0, 1),
            dt, lvl, fb, mix,
            tbv(ins["env3"]), tbv(ins["env2"]), tbv(ins["env1"]),
            fb_static=fb_static)
        return ({"phases": jnp.moveaxis(ph, 0, 1),
                 "prevs": jnp.moveaxis(pv, 0, 1)},
                {"output": jnp.moveaxis(y, 0, 1)})


def build_pivot_voice_fused() -> Graph:
    """PivotVoice with the operator section fused (one kernel) and
    the four envelopes horizontally fused into an AdsrBank."""
    from ..nodes.envelope import AdsrBank
    g = Graph("PivotVoiceFused")
    g.input("frequency", "value", default=440.0)
    g.input("gate", "event")
    for op, d in OP_DEFAULTS.items():
        for k, v in d.items():
            g.input(f"{op}_{k}", "value", default=v)
    g.input("route", "value", default=0.0)
    g.input("cutoff", "value", default=2000.0)
    g.input("resonance", "value", default=0.707)
    for k, v in FILTER_DEFAULTS.items():
        g.input(f"filter_{k}", "value", default=v)
    g.input("filter_env_amount", "value", default=0.0)
    g.output("audio_out", "stream")

    envs = g.add("envs", AdsrBank([
        ("op3", 0.01, 0.1, 0.7, 0.3),
        ("op2", 0.01, 0.1, 0.7, 0.3),
        ("op1", 0.01, 0.2, 0.8, 0.5),
        ("filt", 0.01, 0.2, 0.5, 0.3),
    ]))
    # Gain(amount) -> AddValue(cutoff) fused into one MulAdd (identical
    # fp math; the composed pair is the reference structure and remains
    # in build_pivot_voice, equivalence-tested)
    cutoff_mod = g.add("cutoff_mod", MulAdd(0.0, 2000.0))
    chain = g.add("ops", PivotOperatorChain())
    filt = g.add("filter", TptFilter(2000.0, 0.707))
    out_g = g.add("output_gain", Gain(0.3))

    g.connect("gate", envs.gate)
    for op in ("op3", "op2", "op1"):
        for k in ("attack", "decay", "sustain", "release"):
            g.connect(f"{op}_{k}", f"envs.{op}_{k}")
    for k in ("attack", "decay", "sustain", "release"):
        g.connect(f"filter_{k}", f"envs.filt_{k}")

    g.connect(envs.filt, cutoff_mod.input)
    g.connect("filter_env_amount", cutoff_mod.gain)
    g.connect("cutoff", cutoff_mod.value)
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
    g.connect("resonance", filt.q)
    g.connect(filt.output, out_g.input)
    g.connect(out_g.output, "audio_out")
    return g


def build_pivot_voice() -> Graph:
    """One PivotVoice graph (pivot_voice.rs:10-174)."""
    g = Graph("PivotVoice")
    g.input("frequency", "value", default=440.0)
    g.input("gate", "event")
    for op, d in OP_DEFAULTS.items():
        for k, v in d.items():
            g.input(f"{op}_{k}", "value", default=v)
    g.input("route", "value", default=0.0)
    g.input("cutoff", "value", default=2000.0)
    g.input("resonance", "value", default=0.707)
    for k, v in FILTER_DEFAULTS.items():
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

    # envelope VCAs (stream x stream) + level gains — pivot_voice.rs:72-79
    vca3 = g.add("op3_env_vca", Vca())
    vca2 = g.add("op2_env_vca", Vca())
    vca1 = g.add("op1_env_vca", Vca())
    lvl3 = g.add("op3_level_gain", Gain(0.5))
    lvl2 = g.add("op2_level_gain", Gain(0.5))

    route = g.add("op3_route", Crossfade())
    mix1 = g.add("op1_mod_mixer", Mixer())
    filt = g.add("filter", TptFilter(2000.0, 0.707))
    out_g = g.add("output_gain", Gain(0.3))

    # gate to all envelopes (:96-99); per-stage envelope params (:102-123)
    for env in (env3, env2, env1):
        g.connect("gate", env.gate)
    g.connect("gate", env_f.gate)
    for env_name, op in (("env3", "op3"), ("env2", "op2"), ("env1", "op1")):
        for k in ("attack", "decay", "sustain", "release"):
            g.connect(f"{op}_{k}", f"{env_name}.{k}")
    for k in ("attack", "decay", "sustain", "release"):
        g.connect(f"filter_{k}", f"env_filter.{k}")

    # filter env modulation: env -> gain(amount) -> add(cutoff) (:126-130)
    g.connect(env_f.output, f_gain.input)
    g.connect("filter_env_amount", f_gain.gain)
    g.connect(f_gain.output, cutoff_mod.input)
    g.connect("cutoff", cutoff_mod.value)
    g.connect(cutoff_mod.output, filt.cutoff)

    # OP3: osc -> env_vca -> level_gain -> crossfade (:132-139)
    g.connect("frequency", op3.base_freq)
    g.connect("op3_ratio", op3.ratio)
    g.connect("op3_feedback", op3.feedback)
    g.connect(op3.output, vca3.input)
    g.connect(env3.output, vca3.control)
    g.connect(vca3.output, lvl3.input)
    g.connect("op3_level", lvl3.gain)

    # route crossfade (:141-144)
    g.connect(lvl3.output, route.input)
    g.connect("route", route.mix)
    g.connect(route.output_a, op2.phase_mod)

    # OP2 (:146-153)
    g.connect("frequency", op2.base_freq)
    g.connect("op2_ratio", op2.ratio)
    g.connect("op2_feedback", op2.feedback)
    g.connect(op2.output, vca2.input)
    g.connect(env2.output, vca2.control)
    g.connect(vca2.output, lvl2.input)
    g.connect("op2_level", lvl2.gain)

    # OP1 phase-mod mix (:155-158)
    g.connect(lvl2.output, mix1.input_a)
    g.connect(route.output_b, mix1.input_b)
    g.connect(mix1.output, op1.phase_mod)

    # OP1 carrier -> vca -> filter (:160-165)
    g.connect("frequency", op1.base_freq)
    g.connect("op1_ratio", op1.ratio)
    g.connect(op1.output, vca1.input)
    g.connect(env1.output, vca1.control)
    g.connect(vca1.output, filt.input)

    g.connect("resonance", filt.q)
    g.connect(filt.output, out_g.input)
    g.connect(out_g.output, "audio_out")
    return g


def build_pivot(num_voices: int = 8, fused: bool = True) -> Graph:
    """The PivotGraph app: MIDI -> allocator -> 8 PivotVoices -> fan-in
    (main.rs:59-168; the reference runs 8 voices).  ``fused=True`` (the
    production path) collapses each voice's operator section into the
    PivotOperatorChain kernel and its envelopes into an AdsrBank;
    ``fused=False`` mirrors the reference node for node.  Both are
    equivalence-tested."""
    g = Graph(f"Pivot{num_voices}")
    g.input("midi_in", "event")
    for op, d in OP_DEFAULTS.items():
        for k, v in d.items():
            g.input(f"{op}_{k}", "value", default=v)
    g.input("route", "value", default=0.0)
    g.input("cutoff", "value", default=2000.0)
    g.input("resonance", "value", default=0.707)
    for k, v in FILTER_DEFAULTS.items():
        g.input(f"filter_{k}", "value", default=v)
    g.input("filter_env_amount", "value", default=0.0)
    g.output("audio_out", "stream")

    parser = g.add("parser", MidiParser())
    alloc = g.add("alloc", VoiceAllocator(num_voices))
    handlers = g.add("handlers", MidiVoiceHandler(), count=num_voices)
    voices = g.add("voices",
                   build_pivot_voice_fused() if fused
                   else build_pivot_voice(), count=num_voices)

    g.connect("midi_in", parser.midi_in)
    g.connect(parser.note_on, alloc.note_on)
    g.connect(parser.note_off, alloc.note_off)
    g.connect(alloc.voices, handlers.note_on)
    g.connect(alloc.voices, handlers.note_off)
    g.connect(handlers.frequency, voices.frequency)
    g.connect(handlers.gate, voices.gate)
    # broadcast every UI parameter to all voices (main.rs:128-163)
    for op, d in OP_DEFAULTS.items():
        for k in d:
            g.connect(f"{op}_{k}", f"voices.{op}_{k}")
    for name in ("route", "cutoff", "resonance", "filter_env_amount"):
        g.connect(name, f"voices.{name}")
    for k in FILTER_DEFAULTS:
        g.connect(f"filter_{k}", f"voices.filter_{k}")
    g.connect(voices.audio_out, "audio_out")
    return g
