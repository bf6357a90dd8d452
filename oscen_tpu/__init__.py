"""oscen_tpu — an audio synthesis framework in JAX.

A from-scratch rebuild of the capabilities of reedrosenbluth/oscen
(a Rust compile-time-graph audio engine) for an accelerator (an NVIDIA GPU):
the declarative graph becomes a traced, jit-compiled block function; voices
batch across kernel lanes; per-sample recurrences become scans, prefix sums and
closed forms; control logic (MIDI, voice allocation) runs host-side per
block, mirroring the reference's control-thread↔audio-thread split.

Flat re-exports mirror the reference's ``oscen::prelude``
(/root/reference/oscen-lib/src/prelude.rs).
"""

from .core.events import (EventBuffer, EventInstance, EventQueue,
                          NoteOffEvent, NoteOnEvent, RawMidiMessage,
                          scalar_event)
from .core.ramp import ValueRampState
from .core.types import (DEFAULT_MAX_BLOCK_SIZE, Kind, ParamSpec, Policy,
                         SampleRate)
from .graph.builder import Frame, Graph, GraphError, call
from .graph.dsl import parse_graph
from .graph.node import HostNode, Node
from .nodes.basic import (AddValue, AudioInput, Crossfade, FmOperator, Gain,
                          HardClip, Mixer, MulAdd, Tremolo, Value, Vca)
from .assets import AssetError, AudioAsset
from .nodes.convolver import Convolver
from .nodes.delay import Delay
from .nodes.envelope import AdsrEnvelope
from .nodes.filters import (DualLP18Diff, IirLowpass, LP18Filter,
                            TptFilter)
from .nodes.midi import (EventPassthrough, MidiParser, MidiVoiceHandler,
                         midi_note_to_freq, raw_midi_event)
from .nodes.oscillators import Oscillator, PolyBlepOscillator
from .nodes.oscilloscope import Oscilloscope
from .nodes.sample_player import SamplePlayer
from .nodes.voice_allocator import VoiceAllocator
from .utils.params import FloatParam, NihParams, nih_params

__version__ = "0.1.0"

__all__ = [
    "AddValue", "AdsrEnvelope", "AudioInput", "Crossfade", "Delay",
    "DEFAULT_MAX_BLOCK_SIZE", "EventBuffer", "EventInstance", "EventQueue",
    "AssetError", "AudioAsset", "Convolver", "SamplePlayer",
    "EventPassthrough", "FloatParam", "FmOperator", "Frame", "Gain",
    "Graph", "NihParams", "nih_params",
    "GraphError", "HardClip", "HostNode", "IirLowpass", "Kind",
    "DualLP18Diff", "LP18Filter", "MidiParser", "MidiVoiceHandler",
    "Mixer", "MulAdd",
    "Node",
    "NoteOffEvent", "NoteOnEvent", "Oscillator", "Oscilloscope",
    "ParamSpec",
    "PolyBlepOscillator", "Policy", "RawMidiMessage", "SampleRate",
    "Tremolo", "Value", "ValueRampState", "Vca", "VoiceAllocator", "call",
    "midi_note_to_freq", "parse_graph", "raw_midi_event", "scalar_event",
]
