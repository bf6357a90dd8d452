"""render_convolution — offline convolution-reverb render.

Counterpart of the reference's offline renderer
(/root/reference/examples/src/bin/render_convolution.rs): load an impulse
response (any rate — it conforms to the graph rate), convolve a dry input,
write the wet result.

Run: python examples/render_convolution.py [ir.wav] [out.wav]
(with no IR argument, a synthetic exponentially-decaying noise IR is used)
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from oscen_tpu.utils.cache import enable_compile_cache
enable_compile_cache()  # runs wherever JAX finds a device

from oscen_tpu import AudioAsset, Convolver, Graph, Oscillator


def main():
    ir_path = sys.argv[1] if len(sys.argv) > 1 else None
    out_path = (sys.argv[2] if len(sys.argv) > 2 else
                os.path.join(tempfile.gettempdir(), "reverb_out.wav"))
    sr = 48_000.0

    g = Graph("ConvolutionReverb")
    g.input("x", "stream")
    g.output("out", "stream")
    g.external("ir")
    conv = g.add("conv", Convolver(max_ir_len=1 << 16))
    g.connect("ir", conv.ir)
    g.connect("x", conv.input)
    g.connect(conv.output, "out")
    c = g.compile(sample_rate=sr, block_size=512)

    if ir_path:
        c.load_wav("ir", ir_path)
    else:
        rng = np.random.default_rng(0)
        n = int(sr)
        ir = (rng.standard_normal(n).astype(np.float32)
              * np.exp(-np.arange(n, dtype=np.float32) / (sr * 0.15))
              * 0.05)
        c.publish_asset("ir", AudioAsset.from_samples(ir, int(sr)))
    c.render_mono(2048)  # let the publish crossfade settle

    # dry input: a short plucked arpeggio of clicks
    dry = np.zeros(int(sr * 2), np.float32)
    for i, t in enumerate([0.0, 0.4, 0.8, 1.2]):
        dry[int(t * sr)] = 0.8 * (0.8 ** i)
    wet = c.render_mono(len(dry), stream_inputs={"x": dry}, tail=int(sr))
    AudioAsset.write_wav(out_path, wet, int(sr))
    print(f"wrote {out_path} ({len(wet) / sr:.1f} s, "
          f"peak {np.abs(wet).max():.3f})")


if __name__ == "__main__":
    main()
