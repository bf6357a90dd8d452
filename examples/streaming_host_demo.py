"""streaming_host_demo — callback-paced realtime streaming with live events.

Counterpart of the reference's cpal hosts (simple_synth.rs:30-57,
fm-synth main.rs:197-200): a wall-clock-paced block loop at 48 kHz with
MIDI note events and parameter changes arriving live between callbacks,
plus deadline accounting (the reference's implicit "finish inside the
callback" budget made explicit).

Run: python examples/streaming_host_demo.py [seconds] [block]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from oscen_tpu.utils.cache import enable_compile_cache
enable_compile_cache()  # runs wherever JAX finds a device

import numpy as np

from oscen_tpu import AudioAsset, raw_midi_event
from oscen_tpu.models.poly_synth import build_poly_synth
from oscen_tpu.utils.host import StreamingHost

NOTES = [57, 60, 64, 67, 64, 60]


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 3.0
    block = int(sys.argv[2]) if len(sys.argv) > 2 else 128

    synth = build_poly_synth(8).compile(48000.0, block_size=block,
                                        mode="block")
    host = StreamingHost(synth)

    state = {"next_note": 0.0, "i": 0, "held": None}

    def on_block(h, t):
        # live MIDI: a new note every 0.4 s, release after 0.3 s
        if state["held"] is not None and t >= state["held"][0]:
            h.compiled.queue_event(
                "midi_in", 0, raw_midi_event([0x80, state["held"][1], 0]))
            state["held"] = None
        if t >= state["next_note"]:
            note = NOTES[state["i"] % len(NOTES)]
            h.compiled.queue_event(
                "midi_in", 0, raw_midi_event([0x90, note, 100]))
            state["held"] = (t + 0.3, note)
            state["next_note"] = t + 0.4
            state["i"] += 1
        # live param motion: filter sweep (the UI-slider mpsc analogue)
        if "cutoff" in h.compiled._params:
            h.compiled.set_value("cutoff",
                                 800.0 + 2200.0 * (0.5 + 0.5 * np.sin(t)))

    # Warm up every jit variant outside the paced loop (steady blocks AND
    # event-carrying blocks compile to different specializations); then
    # reset state.  The reference warms up implicitly via its first
    # callbacks; a jit-compiled engine must do it explicitly to keep the
    # realtime clock honest.
    synth.queue_event("midi_in", 0, raw_midi_event([0x90, 60, 100]))
    synth.process_block()
    synth.queue_event("midi_in", 0, raw_midi_event([0x80, 60, 0]))
    synth.queue_event("midi_in", 4, raw_midi_event([0x90, 62, 100]))
    synth.process_block()
    synth.process_block()
    synth.init()
    audio = host.run(seconds, on_block=on_block)
    host.print_report()
    AudioAsset.write_wav(os.path.join(tempfile.gettempdir(), "streaming_demo.wav"),
                         audio, 48000)
    print(f"wrote /tmp/streaming_demo.wav ({len(audio) / 48000.0:.1f} s)")


if __name__ == "__main__":
    main()
