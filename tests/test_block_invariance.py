"""Block-size invariance: output must be bit-identical no matter how the
render is chunked into blocks (the property the reference guarantees by
construction — its per-sample loop doesn't know about blocks; see
/root/reference/oscen-lib/tests/block_processing_test.rs).

The block-mode compiler achieves it with sequential-exact kernels
(phase/TPT/biquad: lax.scan on the CPU, the lane-scan kernel on a GPU) and stage-entry-based
ADSR closed forms (pure functions of the absolute stage age).  The
guarantee holds for block-constant node parameters; events at arbitrary
offsets are fine.
"""

import numpy as np
import pytest

from oscen_tpu import (AdsrEnvelope, Gain, Graph, IirLowpass, Oscillator,
                       PolyBlepOscillator, TptFilter)


def render_chunked(build, total, sizes, events=()):
    """Render `total` samples using the given per-compile block size,
    feeding (abs_offset, name, value) events sample-accurately."""
    outs = {}
    for bs in sizes:
        c = build().compile(48000.0, block_size=bs)
        chunks = []
        pos = 0
        while pos < total:
            n = min(bs, total - pos)
            for (at, name, val) in events:
                if pos <= at < pos + n:
                    c.queue_event(name, at - pos, val)
            chunks.append(np.asarray(c.process_block(n)["out"]))
            pos += n
        outs[bs] = np.concatenate(chunks, axis=0)
    return outs


def assert_all_equal(outs):
    sizes = sorted(outs)
    ref = outs[sizes[0]]
    for bs in sizes[1:]:
        np.testing.assert_array_equal(
            ref, outs[bs], err_msg=f"block {bs} vs {sizes[0]}")


def test_polyblep_saw_invariance():
    def build():
        g = Graph("S")
        g.output("out", "stream")
        o = g.add("o", PolyBlepOscillator.saw(440.0, 0.5))
        g.connect(o.output, "out")
        return g
    assert_all_equal(render_chunked(build, 2048, (512, 128, 64, 96)))


def test_naive_oscillator_invariance():
    def build():
        g = Graph("N")
        g.output("out", "stream")
        o = g.add("o", Oscillator.saw(220.0, 0.7))
        g.connect(o.output, "out")
        return g
    assert_all_equal(render_chunked(build, 2048, (512, 100, 37)))


def test_tpt_filter_invariance():
    def build():
        g = Graph("T")
        g.output("out", "stream")
        o = g.add("o", PolyBlepOscillator.square(220.0, 0.5))
        f = g.add("f", TptFilter(800.0, 2.0))
        g.connect(o.output, f.input)
        g.connect(f.output, "out")
        return g
    assert_all_equal(render_chunked(build, 2048, (512, 128, 64)))


def test_iir_lowpass_invariance():
    """IirLowpass also carries the mod-32 coefficient-update counter
    across blocks; block sizes that are not multiples of 32 exercise it."""
    def build():
        g = Graph("I")
        g.output("out", "stream")
        o = g.add("o", Oscillator.saw(330.0, 0.5))
        f = g.add("f", IirLowpass(1000.0))
        g.connect(o.output, f.input)
        g.connect(f.output, "out")
        return g
    assert_all_equal(render_chunked(build, 2048, (512, 48, 33)))


def test_adsr_gate_events_invariance():
    """Gate on, retrigger mid-decay, gate off — all at absolute offsets
    that land mid-block for every size."""
    def build():
        g = Graph("E")
        g.input("gate", "event")
        g.output("out", "stream")
        e = g.add("e", AdsrEnvelope(0.005, 0.05, 0.5, 0.02))
        g.connect("gate", e.gate)
        g.connect(e.output, "out")
        return g
    events = [(700, "gate", 1.0), (1500, "gate", 0.8), (2900, "gate", 0.0)]
    outs = render_chunked(build, 4096, (512, 128, 160, 1024), events)
    assert_all_equal(outs)
    assert np.abs(outs[512]).max() > 0.1  # the envelope actually opened


def test_adsr_zero_shortcut_invariance():
    def build():
        g = Graph("Z")
        g.input("gate", "event")
        g.output("out", "stream")
        e = g.add("e", AdsrEnvelope(0.0, 0.0, 0.8, 0.01))
        g.connect("gate", e.gate)
        g.connect(e.output, "out")
        return g
    events = [(130, "gate", 1.0), (1000, "gate", 0.0)]
    assert_all_equal(render_chunked(build, 2048, (512, 64), events))


def test_full_voice_invariance():
    """osc * env -> filter, gated mid-block (a realistic synth voice)."""
    def build():
        g = Graph("V")
        g.input("gate", "event")
        g.output("out", "stream")
        o = g.add("o", PolyBlepOscillator.saw(220.0, 0.5))
        e = g.add("e", AdsrEnvelope(0.01, 0.1, 0.6, 0.05))
        f = g.add("f", TptFilter(1500.0, 0.9))
        amp = g.add("amp", Gain(1.0))
        g.connect("gate", e.gate)
        g.connect(o.output, amp.input)
        g.connect(e.output, amp.gain)
        g.connect(amp.output, f.input)
        g.connect(f.output, "out")
        return g
    events = [(333, "gate", 1.0), (3000, "gate", 0.0)]
    outs = render_chunked(build, 4096, (512, 128, 250), events)
    assert_all_equal(outs)
    assert np.abs(outs[512]).max() > 0.05


@pytest.mark.parametrize("policy", ["sinc", "sinc_iir", "linear", "latch"])
def test_multirate_boundary_invariance(policy):
    """Oversampled regions (every resampler family at the boundary) are
    block-size invariant — the IIR halfband allpasses replay the exact
    per-sample op order rather than an associative scan."""
    from oscen_tpu import HardClip

    def run(bs):
        g = Graph("S")
        g.output("out", "stream")
        o = g.add("osc", PolyBlepOscillator.saw(500.0, 0.6), rate=4)
        c = g.add("clip", HardClip(), rate=4)
        g.connect(o.output, c.input)
        g.connect(c.output, "out", policy=policy)
        return g.compile(48000.0, block_size=bs,
                         mode="block").render_mono(2048)

    a, b = run(512), run(128)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_block_size_invariance(seed):
    """Random graphs (oscillators, filters, envelopes, feedback delays,
    events mid-stream): output must be bit-identical across block sizes."""
    from tests.test_fuzz_graphs import _random_graph

    def build():
        rng = np.random.default_rng(1000 + seed)
        return _random_graph(rng, int(rng.integers(3, 9)),
                             with_events=True)

    x = np.random.default_rng(7).standard_normal(1536).astype(
        np.float32) * 0.3

    def run(bs):
        c = build().compile(48000.0, block_size=bs, mode="block")
        out = []
        pos = 0
        while pos < 1536:
            n = min(bs, 1536 - pos)
            if pos <= 333 < pos + n:
                c.queue_event("gate", 333 - pos, 0.9)
            out.append(np.asarray(c.process_block(
                n, stream_inputs={"x": x[pos:pos + n]})["out"]))
            pos += n
        return np.concatenate(out)

    np.testing.assert_array_equal(run(512), run(192))
