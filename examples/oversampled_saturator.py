"""oversampled_saturator — A/B the anti-aliasing of an oversampled clipper.

Counterpart of the reference's oversampled-saturator app
(/root/reference/examples/oversampled-saturator/src/main.rs: a saw into a
hard clipper inside a ``* N`` oversampled region, rendered at several
factors via oversample_variants!).  Renders the same patch at 1x/2x/4x/8x,
reports the alias energy of each, and writes the 1x and 8x renders to WAV
for listening.

Run: python examples/oversampled_saturator.py [out_prefix]
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from oscen_tpu.utils.cache import enable_compile_cache
enable_compile_cache()  # runs wherever JAX finds a device

from oscen_tpu import AudioAsset, Graph, HardClip, PolyBlepOscillator

SR = 44_100.0  # not a multiple of the osc pitch: aliases land off-comb
F0 = 2000.0


def build_saturator(factor: int) -> Graph:
    """The reference graph: saw -> hard clip, both inside a rate=factor
    region, sinc-resampled back to base rate (main.rs:64-80)."""
    g = Graph(f"Saturator{factor}x")
    g.output("audio_out", "stream")
    osc = g.add("osc", PolyBlepOscillator.saw(F0, 0.6), rate=factor)
    clip = g.add("clip", HardClip(), rate=factor)
    g.connect(osc.output, clip.input)
    g.connect(clip.output, "audio_out", policy="sinc")
    return g


def alias_energy(x: np.ndarray) -> float:
    """Spectral energy away from the true harmonic comb of F0."""
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / SR)
    on_comb = np.abs((freqs + F0 / 2) % F0 - F0 / 2) < 80.0
    return float(spec[~on_comb & (freqs > 500)].sum())


def main():
    prefix = (sys.argv[1] if len(sys.argv) > 1 else
              os.path.join(tempfile.gettempdir(), "saturator"))
    renders = {}
    for factor in (1, 2, 4, 8):
        c = build_saturator(factor).compile(SR, block_size=512)
        renders[factor] = np.asarray(c.render_mono(int(SR)))
    base = alias_energy(renders[1][4096:])
    for factor, audio in renders.items():
        e = alias_energy(audio[4096:])
        print(f"{factor}x oversampling: alias energy {e:10.1f}"
              f"  ({e / base:6.1%} of 1x)")
    for factor in (1, 8):
        path = f"{prefix}_{factor}x.wav"
        AudioAsset.write_wav(path, renders[factor] * 0.8, int(SR))
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
