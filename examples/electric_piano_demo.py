"""electric_piano_demo — play a chord progression on the flagship model.

Counterpart of the reference's electric-piano app
(/root/reference/examples/electric-piano/src/main.rs), driven by
programmatic MIDI instead of a device, rendered offline to WAV.

Run: python examples/electric_piano_demo.py [out.wav] [num_voices]
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
from oscen_tpu.models.electric_piano import build_electric_piano


CHORDS = [
    (0.0, [60, 64, 67]),        # C
    (1.0, [57, 60, 64]),        # Am
    (2.0, [65, 69, 72]),        # F
    (3.0, [55, 59, 62, 67]),    # G7-ish
]
RELEASE_AT = 0.9  # seconds after each chord strike


def main():
    out_path = (sys.argv[1] if len(sys.argv) > 1 else
                os.path.join(tempfile.gettempdir(), "epiano_demo.wav"))
    num_voices = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    sr, block = 48_000.0, 480

    piano = build_electric_piano(num_voices).compile(
        sample_rate=sr, block_size=block)

    # absolute-time MIDI schedule -> per-block events
    events = []
    for t0, notes in CHORDS:
        for n in notes:
            events.append((int(t0 * sr), [0x90, n, 100]))
            events.append((int((t0 + RELEASE_AT) * sr), [0x80, n, 0]))
    events.sort(key=lambda e: e[0])

    total = int(sr * 5)
    chunks = []
    pos = 0
    while pos < total:
        n = min(block, total - pos)
        while events and events[0][0] < pos + n:
            off, msg = events.pop(0)
            piano.queue_event("midi_in", off - pos, raw_midi_event(msg))
        chunks.append(np.asarray(piano.process_block(n)["out"]))
        pos += n
    audio = np.concatenate(chunks, axis=0)
    peak = np.abs(audio).max()
    if peak > 0.9:
        audio = audio * (0.9 / peak)
    AudioAsset.write_wav(out_path, audio, int(sr))
    print(f"wrote {out_path} ({len(audio) / sr:.1f} s stereo, "
          f"{num_voices} voices, peak {peak:.2f})")


if __name__ == "__main__":
    main()
