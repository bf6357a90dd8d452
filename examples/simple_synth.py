"""simple_synth — render the README synth to a WAV.

Counterpart of the reference's cpal app
(/root/reference/examples/src/bin/simple_synth.rs); with no audio device in
this environment, the output goes to a file and per-block timing prints,
like the reference's ad-hoc ns-per-process prints.

Run: python examples/simple_synth.py [out.wav]
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from oscen_tpu.utils.cache import enable_compile_cache
enable_compile_cache()  # runs wherever JAX finds a device

from oscen_tpu import AudioAsset
from oscen_tpu.models.simple import build_simple_synth


def main():
    out_path = (sys.argv[1] if len(sys.argv) > 1 else
                os.path.join(tempfile.gettempdir(), "simple_synth.wav"))
    sr = 48_000.0
    synth = build_simple_synth().compile(sample_rate=sr, block_size=512)
    audio = synth.render_mono(int(sr * 2))

    t0 = time.perf_counter()
    synth.process_block()
    print(f"simple_synth/process_block    time:   "
          f"[{(time.perf_counter() - t0) * 1e9:.0f} ns]")

    AudioAsset.write_wav(out_path, np.asarray(audio), int(sr))
    print(f"wrote {out_path} ({len(audio) / sr:.1f} s)")


if __name__ == "__main__":
    main()
