"""Filters.

Counterparts of the reference filters:

- :class:`TptFilter` — Zavalishin topology-preserving SVF lowpass
  (/root/reference/oscen-lib/src/filters/tpt/mod.rs).
- :class:`IirLowpass` — JUCE-style biquad, Direct Form II Transposed
  (/root/reference/oscen-lib/src/filters/iir_lowpass/mod.rs).
- :class:`LP18Filter` — 3-pole Hordijk-style 18 dB/oct lowpass
  (/root/reference/examples/nih-twin-peaks/src/lp18_filter.rs).

``tick`` mirrors the per-sample math exactly (including the
recompute-on-change / every-32-frames coefficient cadences, carried in
state).  ``process_block`` vectorizes the coefficient cadences over the
block and runs the state recurrences sequential-exact through one step
function per family (``tpt_step``, ``biquad_step``, ``lp18_step``), shared
with the lane-parallel kernel.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import SampleRate, stream, value
from ..graph.node import Node
from ..ops.pallas.recurrence import lane_scan

PI = math.pi
F32_EPS = float(np.finfo(np.float32).eps)
DENORMAL_THRESHOLD = 1e-15


def _tpt_coefficients(sr_hz: float, cutoff, q):
    """Zavalishin coefficient set (reference tpt/mod.rs:69-82)."""
    nyquist = sr_hz * 0.5 - F32_EPS
    freq = jnp.clip(cutoff, 20.0, nyquist)
    period = 0.5 / sr_hz
    f = (2.0 * sr_hz) * jnp.tan(2.0 * PI * freq * period) * period
    inv_q = 1.0 / q
    h = 1.0 / (1.0 + inv_q * f + f * f)
    return h, f, inv_q, f + inv_q  # h, g, r, k


def tpt_step(carry, xs):
    """One TPT SVF lowpass tick on lane rows (reference op order,
    tpt/mod.rs:108-123)."""
    z0, z1 = carry
    x, h, g, k = xs
    high = (x - z0 * k - z1) * h
    band = high * g + z0
    low = band * g + z1
    return (high * g + band, band * g + low), low


def biquad_step(carry, xs):
    """One DFII-t biquad tick with the reference's denormal snaps on the
    state taps (iir_lowpass/mod.rs:109-132)."""
    v1, v2 = carry
    x, b0, b1, b2, a1, a2 = xs
    out = b0 * x + v1
    v1 = b1 * x - a1 * out + v2
    v2 = b2 * x - a2 * out
    v1 = jnp.where(jnp.abs(v1) < DENORMAL_THRESHOLD, 0.0, v1)
    v2 = jnp.where(jnp.abs(v2) < DENORMAL_THRESHOLD, 0.0, v2)
    return (v1, v2), out


def lp18_step(carry, xs):
    """One LP18 tick: 3 poles, tanh-saturated first pole
    (nih-twin-peaks/src/lp18_filter.rs)."""
    z0, z1, z2 = carry
    x, g, h = xs
    hp = (x - h * z0 - z1 - z2) / (1.0 + g)
    bp1 = g * hp + z0
    z0n = jnp.tanh(bp1)
    bp2 = g * bp1 + z1
    lp = g * bp2 + z2
    return (z0n, bp2, lp), lp


class TptFilter(Node):
    """Topology-preserving SVF lowpass, generic over channel count."""

    def __init__(self, cutoff: float = 1000.0, q: float = 0.707,
                 channels: int = 1):
        self.cutoff = float(cutoff)
        self.q = float(q)
        self.channels = int(channels)
        self.INPUTS = (stream("input", 0.0, channels=channels),
                       stream("cutoff", self.cutoff),
                       value("q", self.q),
                       stream("f_mod", 0.0))
        self.OUTPUTS = (stream("output", channels=channels),)

    def _zeros(self):
        if self.channels == 1:
            return jnp.float32(0.0)
        return jnp.zeros((self.channels,), jnp.float32)

    def init_state(self, sr: SampleRate):
        h, g, r, k = _tpt_coefficients(sr.hz, jnp.float32(self.cutoff),
                                       jnp.float32(self.q))
        return {
            "z0": self._zeros(), "z1": self._zeros(),
            "current_cutoff": jnp.float32(self.cutoff),
            "current_q": jnp.float32(self.q),
            "h": jnp.float32(h), "g": jnp.float32(g),
            "r": jnp.float32(r), "k": jnp.float32(k),
        }

    @staticmethod
    def _apply_parameter_updates(state, ins, sr_hz):
        """Per-sample parameter sanitize + recompute-on-change
        (reference tpt/mod.rs:85-102)."""
        nyquist = sr_hz * 0.5 - F32_EPS
        max_cutoff = min(nyquist, 20_000.0)
        cutoff_base = jnp.clip(ins["cutoff"], 20.0, max_cutoff)
        q = jnp.clip(ins["q"], 0.1, 10.0)
        modulation = jnp.clip(ins["f_mod"], -1.0, 1.0)
        min_factor = 20.0 / cutoff_base
        max_factor = max_cutoff / cutoff_base
        factor = jnp.clip(1.0 + modulation, min_factor, max_factor)
        cutoff = jnp.clip(cutoff_base * factor, 20.0, max_cutoff)

        changed = jnp.logical_or(
            jnp.abs(cutoff - state["current_cutoff"]) > F32_EPS,
            jnp.abs(q - state["current_q"]) > F32_EPS)
        h, g, r, k = _tpt_coefficients(sr_hz, cutoff, q)
        pick = lambda new, old: jnp.where(changed, new, old)
        return {
            **state,
            "current_cutoff": pick(cutoff, state["current_cutoff"]),
            "current_q": pick(q, state["current_q"]),
            "h": pick(h, state["h"]), "g": pick(g, state["g"]),
            "r": pick(r, state["r"]), "k": pick(k, state["k"]),
        }

    def tick(self, state, ins, sr):
        state = self._apply_parameter_updates(state, ins, sr.hz)
        x = ins["input"]
        h, g, k = state["h"], state["g"], state["k"]
        z0, z1 = state["z0"], state["z1"]
        high = (x - z0 * k - z1) * h
        band = high * g + z0
        low = band * g + z1
        state = {**state, "z0": high * g + band, "z1": band * g + low}
        return state, {"output": low}

    def process_block(self, state, ins, events, sr, block_len):
        # Per-sample coefficient update is data-parallel (depends only on
        # this sample's inputs + change detection against the running
        # value).  With block-constant params (the overwhelmingly common
        # case) the coefficients are block-constant; with per-sample f_mod
        # the change-detection cadence is recompute-every-change, which the
        # vectorized form reproduces exactly because the recompute is a pure
        # function of this sample's params.
        st = self._apply_parameter_updates(
            {**state,
             "current_cutoff": jnp.broadcast_to(state["current_cutoff"],
                                                (block_len,)),
             "current_q": jnp.broadcast_to(state["current_q"], (block_len,))},
            ins, sr.hz)
        h, g, k = st["h"], st["g"], st["k"]
        x = ins["input"]
        z0c = state["z0"] + jnp.zeros_like(x[0])
        z1c = state["z1"] + jnp.zeros_like(x[0])

        # Sequential-exact integration (the reference's per-sample op order):
        # bit-parity with tick and therefore block-size invariant.
        (z0n, z1n), y = lane_scan(tpt_step, (z0c, z1c), (x, h, g, k))

        new_state = {**{k2: (v[-1] if k2 in ("current_cutoff", "current_q",
                                             "h", "g", "r", "k") else v)
                        for k2, v in st.items()},
                     "z0": z0n, "z1": z1n}
        return new_state, {"output": y}

    def process_block_batched(self, state, ins, events, sr, block_len,
                              const_ins=frozenset()):
        """Voice-batched block path: ONE kernel over all instances
        (sequential-in-time, voices in lanes — exact reference op order,
        :func:`tpt_step`).  Used where a kernel route exists, for mono
        node arrays; returns None to fall back otherwise."""
        from ..ops.pallas.util import pallas_mode
        use, _ = pallas_mode()
        if self.channels != 1 or not use:
            return None
        B = block_len

        def coefs(st, i):
            return self._apply_parameter_updates(
                {**st,
                 "current_cutoff": jnp.broadcast_to(st["current_cutoff"],
                                                    (B,)),
                 "current_q": jnp.broadcast_to(st["current_q"], (B,))},
                i, sr.hz)

        # Hoist the per-sample tan out of the coefficient recompute when
        # every parameter row is block-constant (the common case: UI
        # params, or a settled filter envelope) — one [C] coefficient set
        # instead of a [C, B] transcendental sweep.  The per-sample path
        # remains for modulated cutoffs, selected at runtime.  Each
        # branch makes its OWN kernel call, so no [C, B] coefficient
        # arrays cross the cond boundary on the fast branch.
        param_keys = ("cutoff", "q", "f_mod")
        # trace-time constant params (const staging, [1]-shaped graph
        # inputs) need no runtime check and no [C,B] form at all — with
        # every param trace-constant the cond disappears entirely (the
        # fm-synth / poly-synth / UI-knob case)
        rt_keys = tuple(k for k in param_keys if k not in const_ins)
        row0 = {kkey: ins[kkey][:, 0] for kkey in param_keys}  # [C]
        C = ins["input"].shape[0]
        const = jnp.bool_(True)
        for kkey in rt_keys:
            const = jnp.logical_and(
                const, jnp.all(ins[kkey] == ins[kkey][:, :1]))
        fin_keys = ("current_cutoff", "current_q", "h", "g", "r", "k")
        x = jnp.moveaxis(ins["input"], 0, 1)  # [B, C]

        def fast(_):
            st1 = self._apply_parameter_updates(state, row0, sr.hz)
            (z0, z1), y = lane_scan(
                tpt_step, (state["z0"], state["z1"]),
                (x, st1["h"][None], st1["g"][None], st1["k"][None]))
            return (y, z0, z1) + tuple(st1[kkey] for kkey in fin_keys)

        def slow(_):
            # broadcast the trace-constant rows INSIDE the branch so
            # only genuinely varying [C,B] arrays are cond operands
            insl = {kkey: (jnp.broadcast_to(row0[kkey][:, None], (C, B))
                           if kkey in const_ins else ins[kkey])
                    for kkey in param_keys}
            st1 = jax.vmap(coefs)(state, insl)
            (z0, z1), y = lane_scan(
                tpt_step, (state["z0"], state["z1"]),
                (x, jnp.moveaxis(st1["h"], 0, 1),
                 jnp.moveaxis(st1["g"], 0, 1),
                 jnp.moveaxis(st1["k"], 0, 1)))
            return (y, z0, z1) + tuple(st1[kkey][:, -1]
                                       for kkey in fin_keys)

        from ..graph import explain
        if not rt_keys:
            explain.note(kernel="tpt_svf_scan", coef_path="hoisted",
                         const_params=True)
            out = fast(None)
        else:
            explain.note(
                kernel="tpt_svf_scan",
                coef_path="runtime(hoisted when params block-constant)",
                runtime_checked_params=list(rt_keys))
            out = jax.lax.cond(const, fast, slow, operand=None)
        y, z0, z1 = out[0], out[1], out[2]
        fin = dict(zip(fin_keys, out[3:]))
        new_state = {**state, **fin, "z0": z0, "z1": z1}
        return new_state, {"output": jnp.moveaxis(y, 0, 1)}


class IirLowpass(Node):
    """JUCE-style biquad lowpass, Direct Form II Transposed."""

    INPUTS = (stream("input", 0.0), value("cutoff", 1000.0),
              value("q", 1.0 / math.sqrt(2.0)))
    OUTPUTS = (stream("output"),)
    FRAMES_PER_UPDATE = 32

    def __init__(self, cutoff: float = 1000.0,
                 q: float = 1.0 / math.sqrt(2.0)):
        self.cutoff = float(cutoff)
        self.q = float(q)
        self.INPUTS = (stream("input", 0.0), value("cutoff", self.cutoff),
                       value("q", self.q))

    @staticmethod
    def _coefficients(sr_hz, cutoff, q):
        """JUCE makeLowPass (reference iir_lowpass/mod.rs:84-100)."""
        nyquist = sr_hz * 0.5 - F32_EPS
        freq = jnp.clip(cutoff, 20.0, nyquist)
        q = jnp.maximum(q, 0.01)
        n = 1.0 / jnp.tan(PI * freq / sr_hz)
        n2 = n * n
        c1 = 1.0 / (1.0 + 1.0 / q * n + n2)
        b0 = c1
        b1 = c1 * 2.0
        b2 = c1
        a1 = c1 * 2.0 * (1.0 - n2)
        a2 = c1 * (1.0 - 1.0 / q * n + n2)
        return b0, b1, b2, a1, a2

    def init_state(self, sr: SampleRate):
        b0, b1, b2, a1, a2 = self._coefficients(
            sr.hz, jnp.float32(self.cutoff), jnp.float32(self.q))
        return {"b0": b0, "b1": b1, "b2": b2, "a1": a1, "a2": a2,
                "v1": jnp.float32(0.0), "v2": jnp.float32(0.0),
                "frame_counter": jnp.int32(0)}

    def tick(self, state, ins, sr):
        update = state["frame_counter"] == 0
        nb0, nb1, nb2, na1, na2 = self._coefficients(
            sr.hz, ins["cutoff"], ins["q"])
        pick = lambda new, old: jnp.where(update, new, old)
        b0 = pick(nb0, state["b0"]); b1 = pick(nb1, state["b1"])
        b2 = pick(nb2, state["b2"]); a1 = pick(na1, state["a1"])
        a2 = pick(na2, state["a2"])
        counter = (state["frame_counter"] + 1) % self.FRAMES_PER_UPDATE

        x = ins["input"]
        x = jnp.where(jnp.abs(x) < DENORMAL_THRESHOLD, 0.0, x)
        out = b0 * x + state["v1"]
        v1 = b1 * x - a1 * out + state["v2"]
        v2 = b2 * x - a2 * out
        v1 = jnp.where(jnp.abs(v1) < DENORMAL_THRESHOLD, 0.0, v1)
        v2 = jnp.where(jnp.abs(v2) < DENORMAL_THRESHOLD, 0.0, v2)
        return ({"b0": b0, "b1": b1, "b2": b2, "a1": a1, "a2": a2,
                 "v1": v1, "v2": v2, "frame_counter": counter},
                {"output": out})

    def process_block(self, state, ins, events, sr, block_len):
        # Coefficients update on the mod-32 cadence; reproduce it by
        # computing per-sample candidates and latching at counter==0 frames.
        counters = (state["frame_counter"]
                    + jnp.arange(block_len, dtype=jnp.int32)) \
            % self.FRAMES_PER_UPDATE
        nb = self._coefficients(sr.hz, ins["cutoff"], ins["q"])
        upd = counters == 0

        def latch(cand, init):
            # value at t = last candidate at an update frame <= t, else init
            def combine(left, right):
                lv, lh = left
                rv, rh = right
                return (jnp.where(rh, rv, lv), jnp.logical_or(lh, rh))
            vals, have = jax.lax.associative_scan(
                combine, (cand, upd), axis=0)
            return jnp.where(have, vals, init)

        b0 = latch(nb[0] + jnp.zeros((block_len,)), state["b0"])
        b1 = latch(nb[1] + jnp.zeros((block_len,)), state["b1"])
        b2 = latch(nb[2] + jnp.zeros((block_len,)), state["b2"])
        a1 = latch(nb[3] + jnp.zeros((block_len,)), state["a1"])
        a2 = latch(nb[4] + jnp.zeros((block_len,)), state["a2"])

        x = ins["input"]
        x = jnp.where(jnp.abs(x) < DENORMAL_THRESHOLD, 0.0, x)
        # Sequential-exact DFII-t (op-order parity with tick, including the
        # denormal snaps on the state taps) — block-size invariant.
        (v1n, v2n), out = lane_scan(
            biquad_step, (state["v1"], state["v2"]),
            (x, b0, b1, b2, a1, a2))
        counter_next = (state["frame_counter"] + block_len) \
            % self.FRAMES_PER_UPDATE
        return ({"b0": b0[-1], "b1": b1[-1], "b2": b2[-1],
                 "a1": a1[-1], "a2": a2[-1],
                 "v1": v1n, "v2": v2n,
                 "frame_counter": jnp.int32(counter_next)},
                {"output": out})


class LP18Filter(Node):
    """Three-pole 18 dB/oct lowpass with a tanh-saturated first pole
    (reference examples/nih-twin-peaks/src/lp18_filter.rs).

    The tanh on the first integrator makes this a *nonlinear* recurrence;
    the block implementation falls back to the per-sample scan.
    """

    INPUTS = (stream("input", 0.0), value("cutoff", 1000.0),
              value("fmod", 0.0), value("resonance", 0.0))
    OUTPUTS = (stream("output"),)

    def __init__(self, cutoff: float = 1000.0, resonance: float = 0.0):
        self.cutoff = float(cutoff)
        self.resonance = float(np.clip(resonance, 0.0, 0.99))
        self.INPUTS = (stream("input", 0.0), value("cutoff", self.cutoff),
                       value("fmod", 0.0), value("resonance", self.resonance))

    def init_state(self, sr: SampleRate):
        fc = np.clip(self.cutoff / sr.hz, 0.001, 0.33)
        return {"z": jnp.zeros((3,), jnp.float32),
                "g": jnp.float32(np.tan(PI * fc, dtype=np.float32)),
                "h": jnp.float32(2.0 * self.resonance),
                "last_cutoff": jnp.float32(self.cutoff),
                "last_fmod": jnp.float32(0.0),
                "last_resonance": jnp.float32(self.resonance)}

    def tick(self, state, ins, sr):
        cutoff, fmod = ins["cutoff"], ins["fmod"]
        resonance = ins["resonance"]
        cut_changed = jnp.logical_or(cutoff != state["last_cutoff"],
                                     fmod != state["last_fmod"])
        fc = jnp.clip((cutoff + fmod) / sr.hz, 0.001, 0.33)
        g = jnp.where(cut_changed, jnp.tan(PI * fc), state["g"])
        res_changed = resonance != state["last_resonance"]
        res_clamped = jnp.clip(resonance, 0.0, 0.99)
        h = jnp.where(res_changed, 2.0 * res_clamped, state["h"])

        z = state["z"]
        hp = (ins["input"] - h * z[0] - z[1] - z[2]) / (1.0 + g)
        bp1 = g * hp + z[0]
        z0 = jnp.tanh(bp1)
        bp2 = g * bp1 + z[1]
        z1 = bp2
        lp = g * bp2 + z[2]
        z2 = lp
        return ({"z": jnp.stack([z0, z1, z2]), "g": g, "h": h,
                 "last_cutoff": jnp.where(cut_changed, cutoff,
                                          state["last_cutoff"]),
                 "last_fmod": jnp.where(cut_changed, fmod,
                                        state["last_fmod"]),
                 "last_resonance": jnp.where(res_changed, resonance,
                                             state["last_resonance"])},
                {"output": lp})

    def process_block(self, state, ins, events, sr, block_len):
        """Sequential-exact block path: the tanh first pole makes this a
        NONLINEAR recurrence (no associative-scan form exists), so the
        block scans :func:`lp18_step` (exact tick op order —
        nih-twin-peaks/src/lp18_filter.rs) through
        :func:`~oscen_tpu.ops.pallas.recurrence.lane_scan`: the Triton
        kernel on a GPU, ``lax.scan`` on the CPU.  Coefficients replay the recompute-on-change
        cadence vectorized against the carried values — exact for the
        same pure-recompute reason as TptFilter.process_block."""
        B = block_len
        cutoff = jnp.broadcast_to(ins["cutoff"], (B,))
        fmod = jnp.broadcast_to(ins["fmod"], (B,))
        resonance = jnp.broadcast_to(ins["resonance"], (B,))
        cut_changed = jnp.logical_or(cutoff != state["last_cutoff"],
                                     fmod != state["last_fmod"])
        fc = jnp.clip((cutoff + fmod) / sr.hz, 0.001, 0.33)
        g = jnp.where(cut_changed, jnp.tan(PI * fc), state["g"])
        res_changed = resonance != state["last_resonance"]
        h = jnp.where(res_changed,
                      2.0 * jnp.clip(resonance, 0.0, 0.99), state["h"])
        x = ins["input"]
        z = state["z"]
        from ..graph import explain
        explain.note(kernel="lp18_scan", lanes=1, sequential_exact=True)
        zs, y = lane_scan(lp18_step, (z[0], z[1], z[2]), (x, g, h))
        zn = jnp.stack(zs)
        return ({"z": zn, "g": g[-1], "h": h[-1],
                 "last_cutoff": jnp.where(cut_changed, cutoff,
                                          state["last_cutoff"])[-1],
                 "last_fmod": jnp.where(cut_changed, fmod,
                                        state["last_fmod"])[-1],
                 "last_resonance": jnp.where(
                     res_changed, resonance,
                     state["last_resonance"])[-1]},
                {"output": y})


class DualLP18Diff(Node):
    """Fused twin-peaks core: TWO independent LP18 filters over the same
    input, computed in ONE voice-parallel kernel launch; output is their
    difference (the movable resonant band,
    reference examples/nih-twin-peaks/src/lib.rs:15-48).

    The sequential-exact LP18 scan pays the full per-sample serial chain
    per LAUNCH, not per lane — two independent ``LP18Filter`` nodes each
    run a B-step chain one lane wide, while this node runs both filters
    in adjacent lanes of one launch for the cost of one.  All kernel ops
    are elementwise over lanes, so on the kernel path the output is
    bit-identical to the two-node composition; the CPU ``lax.scan``
    matches to the last ulp only (XLA CPU tanh emits different code for
    vector vs scalar shapes).  Pinned by
    tests/test_models_aux.py::test_twin_peaks_fused_matches_two_node.
    """

    INPUTS = (stream("input", 0.0), value("cutoff_a", 1000.0),
              value("cutoff_b", 1900.0), value("fmod", 0.0),
              value("resonance", 0.54))
    OUTPUTS = (stream("output"),)

    def __init__(self, cutoff_a: float = 1000.0, cutoff_b: float = 1900.0,
                 resonance: float = 0.54):
        self.cutoffs = (float(cutoff_a), float(cutoff_b))
        self.resonance = float(np.clip(resonance, 0.0, 0.99))
        self.INPUTS = (stream("input", 0.0),
                       value("cutoff_a", self.cutoffs[0]),
                       value("cutoff_b", self.cutoffs[1]),
                       value("fmod", 0.0),
                       value("resonance", self.resonance))

    def init_state(self, sr: SampleRate):
        fc = np.clip(np.asarray(self.cutoffs) / sr.hz, 0.001, 0.33)
        # tan in float32 to match LP18Filter.init_state bit-for-bit
        return {"z": jnp.zeros((3, 2), jnp.float32),
                "g": jnp.asarray(np.tan(PI * fc, dtype=np.float32)),
                "h": jnp.full((2,), 2.0 * self.resonance, jnp.float32),
                "last_cutoff": jnp.asarray(self.cutoffs, jnp.float32),
                "last_fmod": jnp.zeros((2,), jnp.float32),
                "last_resonance": jnp.full((2,), self.resonance,
                                           jnp.float32)}

    def _coeffs(self, state, cutoff, fmod, resonance, sr):
        # identical elementwise op order to LP18Filter.tick/process_block
        # (nih-twin-peaks/src/lp18_filter.rs), vectorized over the two
        # filter lanes in the trailing axis
        cut_changed = jnp.logical_or(cutoff != state["last_cutoff"],
                                     fmod != state["last_fmod"])
        fc = jnp.clip((cutoff + fmod) / sr.hz, 0.001, 0.33)
        g = jnp.where(cut_changed, jnp.tan(PI * fc), state["g"])
        res_changed = resonance != state["last_resonance"]
        h = jnp.where(res_changed,
                      2.0 * jnp.clip(resonance, 0.0, 0.99), state["h"])
        return cut_changed, res_changed, g, h

    def tick(self, state, ins, sr):
        cutoff = jnp.stack([ins["cutoff_a"], ins["cutoff_b"]])
        fmod = jnp.broadcast_to(ins["fmod"], (2,))
        resonance = jnp.broadcast_to(ins["resonance"], (2,))
        cut_changed, res_changed, g, h = self._coeffs(
            state, cutoff, fmod, resonance, sr)
        z = state["z"]
        hp = (ins["input"] - h * z[0] - z[1] - z[2]) / (1.0 + g)
        bp1 = g * hp + z[0]
        z0 = jnp.tanh(bp1)
        bp2 = g * bp1 + z[1]
        lp = g * bp2 + z[2]
        return ({"z": jnp.stack([z0, bp2, lp]), "g": g, "h": h,
                 "last_cutoff": jnp.where(cut_changed, cutoff,
                                          state["last_cutoff"]),
                 "last_fmod": jnp.where(cut_changed, fmod,
                                        state["last_fmod"]),
                 "last_resonance": jnp.where(res_changed, resonance,
                                             state["last_resonance"])},
                {"output": lp[0] - lp[1]})

    def process_block(self, state, ins, events, sr, block_len):
        B = block_len
        cutoff = jnp.stack(
            [jnp.broadcast_to(ins["cutoff_a"], (B,)),
             jnp.broadcast_to(ins["cutoff_b"], (B,))], axis=-1)
        fmod = jnp.broadcast_to(ins["fmod"][..., None], (B, 2))
        resonance = jnp.broadcast_to(ins["resonance"][..., None], (B, 2))
        cut_changed, res_changed, g, h = self._coeffs(
            state, cutoff, fmod, resonance, sr)
        x = jnp.broadcast_to(ins["input"][:, None], (B, 2))
        z = state["z"]
        from ..graph import explain
        explain.note(kernel="lp18_scan", lanes=2, fused_dual_filter=True,
                     sequential_exact=True)
        zs, y = lane_scan(lp18_step, (z[0], z[1], z[2]), (x, g, h))
        zn = jnp.stack(zs)
        return ({"z": zn, "g": g[-1], "h": h[-1],
                 "last_cutoff": jnp.where(cut_changed, cutoff,
                                          state["last_cutoff"])[-1],
                 "last_fmod": jnp.where(cut_changed, fmod,
                                        state["last_fmod"])[-1],
                 "last_resonance": jnp.where(
                     res_changed, resonance,
                     state["last_resonance"])[-1]},
                {"output": y[:, 0] - y[:, 1]})
