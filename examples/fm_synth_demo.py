"""fm_synth_demo — render a short phrase on the 3-operator FM synth.

Counterpart of the reference's fm-synth app
(/root/reference/examples/fm-synth/src/main.rs: cpal stream + MIDI input
+ UI parameter mpsc), driven by programmatic MIDI instead of a device and
rendered offline to WAV.  Sweeps the ``route`` crossfade (OP3 -> OP2 vs
OP3 -> carrier mixer) and the filter cutoff mid-phrase the way the
reference app's UI sliders would.

Run: python examples/fm_synth_demo.py [out.wav] [num_voices]
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from oscen_tpu.utils.cache import enable_compile_cache
enable_compile_cache()  # runs wherever JAX finds a device

from oscen_tpu import AudioAsset, raw_midi_event
from oscen_tpu.models.fm_synth import build_fm_synth

NOTES = [
    (0.00, 45, 0.9), (0.50, 57, 0.8), (1.00, 60, 0.8), (1.50, 64, 0.9),
    (2.00, 45, 0.9), (2.50, 55, 0.7), (3.00, 59, 0.8), (3.50, 62, 0.9),
]
GATE_SECONDS = 0.45


def main():
    out_path = (sys.argv[1] if len(sys.argv) > 1 else
                os.path.join(tempfile.gettempdir(), "fm_demo.wav"))
    num_voices = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    sr, block = 48_000.0, 480

    synth = build_fm_synth(num_voices).compile(sample_rate=sr,
                                               block_size=block)

    events = []
    for t0, note, vel in NOTES:
        events.append((int(t0 * sr), [0x90, note, int(vel * 127)]))
        events.append((int((t0 + GATE_SECONDS) * sr), [0x80, note, 0]))
    events.sort(key=lambda e: e[0])

    total = int(sr * 4.5)
    chunks = []
    pos = 0
    while pos < total:
        n = min(block, total - pos)
        t = pos / sr
        # UI-style parameter motion: route sweeps 0 -> 1, cutoff opens
        synth.set_value("route", min(t / 4.0, 1.0))
        synth.set_value("filter_cutoff", 800.0 + 2400.0 * min(t / 4.0, 1.0))
        while events and events[0][0] < pos + n:
            off, msg = events.pop(0)
            synth.queue_event("midi_in", off - pos, raw_midi_event(msg))
        chunks.append(np.asarray(synth.process_block(n)["audio_out"]))
        pos += n
    audio = np.concatenate(chunks, axis=0)
    peak = np.abs(audio).max()
    if peak > 0.9:
        audio = audio * (0.9 / peak)
    AudioAsset.write_wav(out_path, audio, int(sr))
    print(f"wrote {out_path} ({len(audio) / sr:.1f} s, "
          f"{num_voices} voices, peak {peak:.2f})")


if __name__ == "__main__":
    main()
