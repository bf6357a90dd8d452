"""pivot_demo — the reference's flagship Pivot synth, rendered offline.

Counterpart of /root/reference/examples/pivot/src/main.rs (cpal stream +
slint UI + MIDI): an 8-voice, 3-operator FM synth whose `route` parameter
pivots OP3's modulation between OP2 (route=0) and the carrier (route=1),
with per-operator envelopes applied through VCAs and a filter envelope.
Driven by programmatic MIDI; sweeps `route` and `filter_env_amount` the
way the app's UI sliders would.

Run: python examples/pivot_demo.py [out.wav] [num_voices]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from oscen_tpu.utils.cache import enable_compile_cache
enable_compile_cache()  # runs wherever JAX finds a device

import numpy as np

from oscen_tpu import AudioAsset, raw_midi_event
from oscen_tpu.models.pivot import build_pivot

CHORDS = [
    (0.0, (48, 60, 64, 67)),   # Cmaj
    (1.2, (45, 57, 60, 64)),   # Am
    (2.4, (41, 53, 57, 60)),   # F
    (3.6, (43, 55, 59, 62)),   # G
]
GATE_SECONDS = 1.0


def main():
    out_path = (sys.argv[1] if len(sys.argv) > 1 else
                os.path.join(tempfile.gettempdir(), "pivot_demo.wav"))
    num_voices = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    sr, block = 48_000.0, 480

    synth = build_pivot(num_voices).compile(sample_rate=sr,
                                            block_size=block)
    synth.set_value("op3_feedback", 0.3)
    synth.set_value("filter_env_amount", 1500.0)

    events = []
    for t0, notes in CHORDS:
        for note in notes:
            events.append((int(t0 * sr), [0x90, note, 100]))
            events.append((int((t0 + GATE_SECONDS) * sr), [0x80, note, 0]))
    events.sort(key=lambda e: e[0])

    total = int(sr * 5.2)
    chunks = []
    pos = 0
    while pos < total:
        n = min(block, total - pos)
        t = pos / sr
        synth.set_value("route", min(t / 4.0, 1.0))  # pivot OP3 -> carrier
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
