"""CompiledGraph.explain(): the perf contract is inspectable.

Fast-path engagement (const-dt, zero-feedback, fan-in fusion, island
classification) lives in trace-time branches
and runtime ``lax.cond`` predicates — a user flipping an FM feedback param
to 1e-6 silently loses the vectorized branch; explain() shows why.  The
reference exposes the analogous structure as public generated fields
(examples/electric-piano/src/main.rs:364-368).
"""

import numpy as np
import pytest

from oscen_tpu import Graph
from oscen_tpu.models.fm_synth import build_fm_synth
from oscen_tpu.models.fm_synth import FmOperatorChain


def _entry(entries, node, **match):
    found = [e for e in entries if e.get("node") == node
             and all(e.get(k) == v for k, v in match.items())]
    return found


def test_fm_synth_fast_path_on(monkeypatch):
    """Default fm_synth: feedbacks are flattened-subgraph Consts at 0.0 —
    the zero-feedback branch resolves ON at trace time."""
    monkeypatch.setenv("OSCEN_PALLAS_INTERPRET", "1")
    g = build_fm_synth(4)
    c = g.compile(48000.0, block_size=64, mode="block")
    entries = c.explain()
    chains = [e for e in entries if e.get("kernel") == "fm_chain3"]
    assert chains, entries
    e = chains[0]
    assert e["fast_path"] == "zero_feedback"
    assert e["eligible"] is True
    assert e["engaged"] is True
    # the chain node took the batched kernel path
    assert _entry(entries, e["node"], path="batched")
    # formatted report renders
    rep = c.explain(formatted=True)
    assert "fm_chain3" in rep and "engaged=True" in rep


def test_fm_feedback_disengages_fast_path(monkeypatch):
    """A voice whose feedback default is nonzero reports engaged=False;
    flipping a live feedback param from 0 to nonzero flips the report."""
    monkeypatch.setenv("OSCEN_PALLAS_INTERPRET", "1")

    def voice(fb_default=None, fb_input=False):
        v = Graph("V")
        v.input("gate", "event")
        v.output("out", "stream")
        if fb_input:
            v.input("fb", "value", default=0.0)
        ch = v.add("chain", FmOperatorChain())
        if fb_default is not None:
            v.input("fbd", "value", default=fb_default)
            v.connect("fbd", ch.op3_feedback)
        if fb_input:
            v.connect("fb", ch.op3_feedback)
        v.connect(ch.output, "out")
        return v

    def synth(**kw):
        g = Graph("S")
        g.input("gate", "event")
        if kw.get("fb_input"):
            g.input("fb", "value", default=0.0)
        vs = g.add("voices", voice(**kw), count=4)
        g.connect("gate", vs.gate)
        if kw.get("fb_input"):
            g.connect("fb", vs.fb)
        g.output("out", "stream")
        g.connect(vs.out, "out")
        return g

    # nonzero feedback default -> fast path OFF
    c = synth(fb_default=0.5).compile(48000.0, block_size=64, mode="block")
    e = [x for x in c.explain() if x.get("kernel") == "fm_chain3"][0]
    assert e["engaged"] is False

    # live feedback param: ON at its 0.0 default, OFF after a set_value
    c2 = synth(fb_input=True).compile(48000.0, block_size=64, mode="block")
    e2 = [x for x in c2.explain() if x.get("kernel") == "fm_chain3"][0]
    assert e2["engaged"] is True
    c2.set_value("fb", 1e-6)  # tiny but nonzero: the branch is lost
    e3 = [x for x in c2.explain() if x.get("kernel") == "fm_chain3"][0]
    assert e3["engaged"] is False


def test_explain_is_side_effect_free(monkeypatch):
    """explain() must not consume queued events, advance ramps, or touch
    the allocator's LRU state — the next process_block sees everything."""
    monkeypatch.setenv("OSCEN_PALLAS_INTERPRET", "1")
    from oscen_tpu import raw_midi_event
    g = build_fm_synth(4)
    c = g.compile(48000.0, block_size=64, mode="block")
    c.queue_event("midi_in", 3, raw_midi_event([0x90, 60, 100]))
    c.set_value_with_ramp("filter_cutoff", 4000.0, 128)
    ramp_before = (c._params["filter_cutoff"].current,
                   c._params["filter_cutoff"].frames_remaining)
    qlen_before = len(c._event_queues["midi_in"])
    c.explain()
    assert len(c._event_queues["midi_in"]) == qlen_before
    assert (c._params["filter_cutoff"].current,
            c._params["filter_cutoff"].frames_remaining) == ramp_before
    out = c.process_block()
    audio = np.asarray(next(iter(out.values())))
    assert np.abs(audio).max() > 0.0  # the note-on landed


def test_electric_piano_explain(monkeypatch):
    """Flagship: fused additive kernel with in-kernel fan-in mixdown."""
    monkeypatch.setenv("OSCEN_PALLAS_INTERPRET", "1")
    from oscen_tpu.models.electric_piano import build_electric_piano
    g = build_electric_piano(8)
    c = g.compile(48000.0, block_size=64, mode="block")
    entries = c.explain()
    adds = [e for e in entries if e.get("kernel") == "additive_voice"]
    assert adds, entries
    assert adds[0]["fanin_mixdown_fused"] is True
    assert _entry(entries, adds[0]["node"], path="batched")


def test_literal_params_fold_modulation_path(monkeypatch):
    """Never-touched graph params stage as TRACE-TIME LITERALS: the
    pivot's filter_env_amount defaults to 0.0, so the cutoff-modulation
    MulAdd compiles to a constant (const_out_eps) and the TptFilter
    hoists its coefficients with NO runtime cond.  Setting the param
    mid-run moves it to runtime staging (one bounded retrace) and the
    audio matches the always-runtime staging bit-for-bit."""
    import numpy as np
    from oscen_tpu import raw_midi_event
    from oscen_tpu.models.pivot import build_pivot

    def run(literal):
        monkeypatch.setenv("OSCEN_LITERAL_PARAMS",
                           "1" if literal else "0")
        s = build_pivot(4).compile(48000.0, block_size=128, mode="block")
        s.queue_event("midi_in", 0, raw_midi_event([0x90, 60, 100]))
        a = s.render_mono(512)
        # raise the modulation amount mid-run: the literal class must
        # hand off to runtime staging with identical audio
        s.set_value("filter_env_amount", 800.0)
        b = s.render_mono(512)
        return np.concatenate([a, b]), s

    a, sa = run(True)
    b, sb = run(False)
    np.testing.assert_array_equal(a, b)

    # explain (batched kernel path via interpret mode): with the
    # literal default the cutoff-mod output is a proven constant and the
    # filter compiles the hoisted coefficient path with NO runtime check
    monkeypatch.setenv("OSCEN_LITERAL_PARAMS", "1")
    monkeypatch.setenv("OSCEN_PALLAS_INTERPRET", "1")
    s = build_pivot(4).compile(48000.0, block_size=128, mode="block")
    notes = str(s.explain())
    assert "const_outputs" in notes, notes
    assert "const_params" in notes or "hoisted" in notes, notes
    # and with the amount raised, the specialization is off
    monkeypatch.setenv("OSCEN_LITERAL_PARAMS", "1")
    s2 = build_pivot(4).compile(48000.0, block_size=128, mode="block")
    s2.set_value("filter_env_amount", 500.0)
    notes2 = str(s2.explain())
    assert "const_outputs" not in notes2, notes2


def test_twin_peaks_fused_kernel_noted(monkeypatch):
    """twin_peaks' fused build reports the single 2-lane lp18_scan
    launch; the two-node build reports two 1-lane launches — the launch
    count is the cost of the sequential filter, so it must be
    inspectable."""
    monkeypatch.setenv("OSCEN_PALLAS_INTERPRET", "1")
    from oscen_tpu.models.twin_peaks import build_twin_peaks

    c = build_twin_peaks(fused=True).compile(48000.0, block_size=64,
                                             mode="block")
    fused = [e for e in c.explain() if e.get("kernel") == "lp18_scan"]
    assert len(fused) == 1, fused
    assert fused[0]["lanes"] == 2 and fused[0]["fused_dual_filter"]

    c2 = build_twin_peaks(fused=False).compile(48000.0, block_size=64,
                                               mode="block")
    two = [e for e in c2.explain() if e.get("kernel") == "lp18_scan"]
    assert len(two) == 2, two
    assert all(e["lanes"] == 1 for e in two)
