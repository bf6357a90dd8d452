"""Multirate oversampling: resampler kernel quality, the oversampled
saturator, and mode equivalence.

Mirrors: reference resampler passband tests (tests/resample_kernels.rs),
aliasing-reduction spectral assertions (tests/multirate_graph.rs
hardclip_4x_has_less_aliasing_than_1x), latency accounting
(sinc_fir.rs:191-206).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from oscen_tpu import Graph, HardClip, PolyBlepOscillator
from oscen_tpu.ops import resample as rs


def _run_updown(up, down, x):
    su = up.init_state(jnp.zeros((1,)))
    sd = down.init_state(jnp.zeros((1,)))
    su, hi = jax.jit(up.process_block)(su, jnp.asarray(x))
    sd, lo = jax.jit(down.process_block)(sd, hi)
    return np.asarray(lo)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sinc_fir_passband_roundtrip(n):
    """A sub-passband sine survives the up->down cascade within the
    reference's documented error margins (tests/resample_kernels.rs)."""
    sr = 48_000.0
    freq = 1_000.0
    t = np.arange(4096, dtype=np.float32)
    x = np.sin(2 * np.pi * freq * t / sr).astype(np.float32)
    up = rs.SincUpFir(n)
    down = rs.SincDownFir(n)
    lo = _run_updown(up, down, x)
    # total group delay at the low rate: 11*(n-1)/n per stage pair ≈ 22
    delay = round(2 * rs.HALFBAND_23_GROUP_DELAY * (n - 1) / n)
    ref = np.roll(x, delay)
    err = np.abs(lo[200:3800] - ref[200:3800]).max()
    assert err < 0.1, err


def test_sinc_fir_passband_is_bug_sensitive():
    """The passband threshold would actually catch a broken kernel: a
    corrupted filter-history state blows the error far past the 0.1
    threshold (reference resample_kernels.rs:355-466, which documents
    'corrupting prev_odd_in -> max_err 0.75 vs threshold 0.1')."""
    sr = 48_000.0
    t = np.arange(4096, dtype=np.float32)
    x = np.sin(2 * np.pi * 1000.0 * t / sr).astype(np.float32)
    up, down = rs.SincUpFir(2), rs.SincDownFir(2)
    su = up.init_state(jnp.zeros((1,)))
    # corrupt one stage's carried history the way a wrong-index bug would
    su = jax.tree_util.tree_map(lambda h: h + 0.5, su)
    sd = down.init_state(jnp.zeros((1,)))
    su, hi = jax.jit(up.process_block)(su, jnp.asarray(x))
    sd, lo = jax.jit(down.process_block)(sd, hi)
    delay = round(2 * rs.HALFBAND_23_GROUP_DELAY * 1 / 2)
    err = np.abs(np.asarray(lo)[:600] - np.roll(x, delay)[:600]).max()
    assert err > 0.1, err  # the quality gate is sensitive to state bugs


@pytest.mark.parametrize("n", [2, 4, 8])
def test_iir_halfband_passband_roundtrip(n):
    sr = 48_000.0
    freq = 1_000.0
    t = np.arange(4096, dtype=np.float32)
    x = np.sin(2 * np.pi * freq * t / sr).astype(np.float32)
    lo = _run_updown(rs.IirHalfbandUp(n), rs.IirHalfbandDown(n), x)
    # allpass phase: compare amplitude envelope instead of exact alignment
    amp = np.abs(lo[500:3500]).max()
    assert 0.9 < amp < 1.1, amp
    # and correlation with a small-lag-scanned reference
    best = 0.0
    for lag in range(0, 12):
        r = np.corrcoef(lo[500:3500], np.roll(x, lag)[500:3500])[0, 1]
        best = max(best, r)
    assert best > 0.995, best


def test_latch_linear_updown():
    x = np.arange(8, dtype=np.float32)
    up = rs.LatchUp(4)
    _, y = up.process_block(up.init_state(), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y), np.repeat(x, 4))
    down = rs.LatchDown(4)
    _, z = down.process_block(down.init_state(), y)
    np.testing.assert_array_equal(np.asarray(z), x)

    lup = rs.LinearUp(2)
    st = lup.init_state(jnp.zeros((1,)))
    _, y = lup.process_block(st, jnp.asarray(x))
    # out[2t] = prev, out[2t+1] = midpoint (reference linear.rs:22-41)
    np.testing.assert_allclose(np.asarray(y)[:6],
                               [0.0, 0.0, 0.0, 0.5, 1.0, 1.5], atol=1e-6)
    ldown = rs.LinearDown(4)
    _, z = ldown.process_block(ldown.init_state(), jnp.asarray(
        np.arange(8, dtype=np.float32)))
    np.testing.assert_allclose(np.asarray(z), [1.5, 5.5], atol=1e-6)


@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sinc_fir_carried_history_split_invariance(direction, n):
    """The sinc FIR cascades carry their histories across blocks: a
    stream processed in three blocks equals the same stream processed in
    one (every cascade depth, both directions)."""
    x = np.random.default_rng(n).standard_normal(3 * 256).astype(np.float32)
    k = rs.SincUpFir(n) if direction == "up" else rs.SincDownFir(n)
    _, whole = k.process_block(k.init_state(), jnp.asarray(x))
    st, parts = k.init_state(), []
    for i in range(3):
        st, y = k.process_block(st, jnp.asarray(x[i * 256:(i + 1) * 256]))
        parts.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(parts), np.asarray(whole),
                               atol=1e-6)


def test_sinc_dc_gain_unity():
    """Both FIR directions preserve DC at unity (coeffs.rs:15-17)."""
    x = np.ones(1024, np.float32)
    up = rs.SincUpFir(2)
    _, hi = up.process_block(up.init_state(jnp.zeros((1,))),
                             jnp.asarray(x))
    assert abs(float(np.asarray(hi)[-1]) - 1.0) < 1e-3
    down = rs.SincDownFir(2)
    _, lo = down.process_block(down.init_state(jnp.zeros((1,))), hi)
    assert abs(float(np.asarray(lo)[-1]) - 1.0) < 1e-3


from oscen_tpu.models.simple import build_saturator  # noqa: E402


def _bin_mag(x, sr, freq):
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    freqs = np.fft.rfftfreq(len(x), 1 / sr)
    return spec[np.argmin(np.abs(freqs - freq))]


@pytest.mark.parametrize("mode", ["sample", "block"])
def test_hardclip_4x_less_aliasing_than_1x(mode):
    """4x oversampled hard clip shows less alias energy
    (tests/multirate_graph.rs)."""
    # 44.1 kHz: not an integer multiple of 2 kHz, so folded harmonics land
    # off the harmonic comb and are measurable (at 48 kHz every alias of a
    # 2 kHz harmonic folds exactly onto another harmonic).
    sr = 44_100.0
    out = {}
    for factor in (1, 4):
        c = build_saturator(factor).compile(sr, block_size=512, mode=mode)
        out[factor] = c.render_mono(8192)[4096:]
    f0 = 2000.0
    # an alias of a high harmonic of 2 kHz: e.g. 13*2k=26k aliases to 22k;
    # measure total energy away from true harmonics
    def alias_energy(x):
        spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
        freqs = np.fft.rfftfreq(len(x), 1 / sr)
        harm = (np.abs((freqs + f0 / 2) % f0 - f0 / 2) < 80.0)
        return spec[~harm & (freqs > 500)].sum()
    assert alias_energy(out[4]) < 0.5 * alias_energy(out[1]), \
        (alias_energy(out[4]), alias_energy(out[1]))
    # both still carry the fundamental strongly
    assert _bin_mag(out[4], sr, f0) > 50


def test_multirate_modes_agree():
    a = build_saturator(4).compile(48000.0, 256,
                                   mode="sample").render_mono(1024)
    b = build_saturator(4).compile(48000.0, 256,
                                   mode="block").render_mono(1024)
    rms = np.sqrt(np.mean((a - b) ** 2))
    assert rms < 1e-3, rms


def test_multirate_value_edge_latch():
    """A value input into an oversampled node takes the latch kernel by
    default (kernel refinement: value Default -> Latch)."""
    g = Graph("VL")
    g.input("freq", "value", default=100.0)
    g.output("out", "stream")
    osc = g.add("osc", PolyBlepOscillator.sine(100.0, 1.0), rate=2)
    g.connect("freq", osc.frequency)
    g.connect(osc.output, "out", policy="sinc")
    c = g.compile(48000.0, block_size=256)
    out = c.render_mono(2048)
    spec = np.abs(np.fft.rfft(out[512:] * np.hanning(1536)))
    freqs = np.fft.rfftfreq(1536, 1 / 48000.0)
    peak = freqs[spec.argmax()]
    assert abs(peak - 100.0) < 40.0, peak


@pytest.mark.parametrize("mode", ["sample", "block"])
def test_event_offsets_rescale_into_oversampled_region(mode):
    """Events into an oversampled node fire at offset*N inner ticks ==
    the same outer time (reference EdgeKernel::Event{Multiply} +
    emit_frame event drains)."""
    from oscen_tpu import AdsrEnvelope

    g = Graph("EvR")
    g.input("gate", "event")
    g.output("out", "stream")
    env = g.add("env", AdsrEnvelope(0.0, 0.5, 1.0, 0.1), rate=2)
    g.connect("gate", env.gate)
    g.connect(env.output, "out", policy="latch")
    c = g.compile(48000.0, block_size=128, mode=mode)
    c.queue_event("gate", 40, 1.0)
    out = np.asarray(c.process_block()["out"])
    # zero-attack: level jumps to 1 exactly at outer sample 40
    assert np.all(out[:40] == 0.0), np.nonzero(out[:40])
    assert out[40] > 0.9, out[38:44]


def test_block_convolver_fdl_engine():
    """The uniform-partition FDL engine (ops/conv.py BlockConvolver, the
    fixed-block serving path) computes exact zero-latency convolution."""
    import jax
    from oscen_tpu.ops.conv import BlockConvolver

    rng = np.random.default_rng(0)
    ir = rng.standard_normal(100).astype(np.float32)
    x = rng.standard_normal(256).astype(np.float32)
    conv = BlockConvolver(block_size=64, max_ir_len=128)
    h = jnp.asarray(conv.ir_spectra(ir))
    st = conv.init_state()
    ys = []
    step = jax.jit(lambda s, xx: conv.process_block(s, h, xx))
    for i in range(4):
        st, y = step(st, jnp.asarray(x[i * 64:(i + 1) * 64]))
        ys.append(np.asarray(y))
    out = np.concatenate(ys)
    ref = np.convolve(x, ir)[:256]
    np.testing.assert_allclose(out, ref, atol=2e-4)


@pytest.mark.parametrize("mode", ["sample", "block"])
def test_oversampled_node_arrays(mode):
    """Node arrays inside an oversampled region (voices x rate): the
    cross-rate resamplers batch over the instance axis."""
    g = Graph("OVA")
    g.input("drive", "value", default=1.0)
    g.output("out", "stream")
    oscs = g.add("oscs", PolyBlepOscillator.saw(500.0, 0.4), count=4,
                 rate=2)
    clips = g.add("clips", HardClip(), count=4, rate=2)
    from oscen_tpu import Gain
    mix = g.add("mix", Gain(0.25))
    g.connect(oscs.output, clips.input)
    g.connect(clips.output, mix.input, policy="sinc")  # 4->1 fan-in, down
    g.connect("drive", mix.gain)
    g.connect(mix.output, "out")
    c = g.compile(48000.0, block_size=128, mode=mode)
    out = c.render_mono(512)
    assert np.all(np.isfinite(out))
    assert np.abs(out[200:]).max() > 0.05


def test_oversampled_arrays_modes_agree():
    def run(mode):
        g = Graph("OVA2")
        g.output("out", "stream")
        oscs = g.add("oscs", PolyBlepOscillator.saw(500.0, 0.4), count=4,
                     rate=2)
        clips = g.add("clips", HardClip(), count=4, rate=2)
        from oscen_tpu import Gain
        mix = g.add("mix", Gain(0.25))
        g.connect(oscs.output, clips.input)
        g.connect(clips.output, mix.input, policy="sinc")
        g.connect(mix.output, "out")
        return g.compile(48000.0, 128, mode=mode).render_mono(512)
    a, b = run("sample"), run("block")
    assert np.sqrt(np.mean((a - b) ** 2)) < 1e-3


def test_oversampled_feedback_island_block_mode():
    """A feedback cycle living entirely inside a 2x region (mix -> clip
    -> delay -> back) runs in block mode as an inner-rate island scan and
    matches sample mode (the reference's inner loop runs island nodes per
    inner tick, emit_frame.rs:114-176)."""
    from oscen_tpu.nodes.basic import Mixer
    from oscen_tpu.nodes.delay import Delay

    def run(mode, bs):
        g = Graph("SatEcho2x")
        g.input("x", "stream")
        g.output("out", "stream")
        mix = g.add("mix", Mixer(), rate=2)
        clip = g.add("clip", HardClip(), rate=2)
        d = g.add("d", Delay(97.0, 0.45), rate=2)
        g.connect("x", mix.input_a, policy="sinc")
        g.connect(mix.output, clip.input)
        g.connect(clip.output, d.input)
        g.connect(d.output, mix.input_b, feedback=True)
        g.connect(clip.output, "out", policy="sinc")
        c = g.compile(48000.0, block_size=bs, mode=mode)
        rng = np.random.default_rng(5)
        x = (rng.standard_normal(512) * 0.4).astype(np.float32)
        return c.render_mono(512, stream_inputs={"x": x})

    a = run("sample", 128)
    b = run("block", 128)
    np.testing.assert_allclose(a, b, atol=1e-6)
    assert np.abs(a).max() > 0.01
    # block-size invariance of the inner-rate island scan
    c = run("block", 64)
    np.testing.assert_array_equal(b, c)


def test_oversampled_feedback_island_with_events():
    """Mid-block events reaching an oversampled island node land on the
    inner timeline (offsets pre-scaled by the host prepass)."""
    from oscen_tpu.nodes.basic import Mixer
    from oscen_tpu.nodes.delay import Delay
    from oscen_tpu.nodes.envelope import AdsrEnvelope
    from oscen_tpu.nodes.basic import Vca

    def run(mode):
        g = Graph("EnvEcho2x")
        g.input("x", "stream")
        g.input("gate", "event")
        g.output("out", "stream")
        env = g.add("env", AdsrEnvelope(attack=0.002, decay=0.05,
                                        sustain=0.5, release=0.1), rate=2)
        vca = g.add("vca", Vca(), rate=2)
        d = g.add("d", Delay(61.0, 0.4), rate=2)
        mix = g.add("mix", Mixer(), rate=2)
        g.connect("x", vca.input, policy="sinc")
        g.connect("gate", env.gate)
        g.connect(env.output, vca.control)
        g.connect(vca.output, mix.input_a)
        g.connect(mix.output, d.input)
        g.connect(d.output, mix.input_b, feedback=True)
        g.connect(mix.output, "out", policy="sinc")
        c = g.compile(48000.0, block_size=128, mode=mode)
        rng = np.random.default_rng(6)
        x = (rng.standard_normal(384) * 0.3).astype(np.float32)
        c.queue_event("gate", 37, 0.9)
        out = [np.asarray(c.process_block(
            stream_inputs={"x": x[i * 128:(i + 1) * 128]})["out"])
            for i in range(3)]
        return np.concatenate(out)

    a = run("sample")
    b = run("block")
    np.testing.assert_allclose(a, b, atol=1e-6)
    assert np.abs(a).max() > 0.001


def test_iir_halfband_pallas_matches_scan(monkeypatch):
    """The allpass-cascade kernel (interpret mode) is bit-identical
    to the sequential lax.scan path (same per-sample op order)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal(300).astype(np.float32)

    def updown(env_on):
        if env_on:
            monkeypatch.setenv("OSCEN_PALLAS_INTERPRET", "1")
        else:
            monkeypatch.delenv("OSCEN_PALLAS_INTERPRET", raising=False)
        up = rs.IirHalfbandUp(2)
        dn = rs.IirHalfbandDown(2)
        su = up.init_state(jnp.zeros((1,)))
        sd = dn.init_state(jnp.zeros((1,)))
        outs = []
        for i in range(3):                 # carried histories across blocks
            chunk = jnp.asarray(x[i * 100:(i + 1) * 100])
            su, hi = up.process_block(su, chunk)
            sd, lo = dn.process_block(sd, hi)
            outs.append(np.asarray(lo))
        return np.concatenate(outs)

    a = updown(False)
    b = updown(True)
    np.testing.assert_array_equal(a, b)
