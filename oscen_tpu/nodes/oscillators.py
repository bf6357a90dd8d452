"""Oscillators.

Counterparts of the reference oscillators
(/root/reference/oscen-lib/src/oscillators/mod.rs).  ``tick`` mirrors the
per-sample reference math exactly (op-order parity for the sample-mode
compiler); ``process_block`` vectorizes the time axis — phase accumulation
becomes a wrapped prefix sum and the polyBLEP residual is branchless masked
arithmetic on the whole block.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..core.types import SampleRate, stream, value
from ..graph.node import Node
from ..ops.scan import exact_wrapped_phase

TAU = 2.0 * math.pi
F32_EPS = float(np.finfo(np.float32).eps)


def _wrap_phase(p):
    """``rem_euclid(1.0)`` (reference oscillators/mod.rs:171-174)."""
    return p - jnp.floor(p)


def _rust_rem(p):
    """Rust ``%`` (truncated remainder) by 1.0."""
    return p - jnp.trunc(p)


# --------------------------------------------------------------------- #
# Naive Oscillator (fn-pointer waveform; reference oscillators/mod.rs:7-76)
# --------------------------------------------------------------------- #
def _naive_sine(p):
    return jnp.sin(p * TAU)


def _naive_square(p):
    return jnp.where(p < 0.5, 1.0, -1.0)


def _naive_saw(p):
    """Reference 'anti-aliased' saw with a polynomial transition region
    (oscillators/mod.rs:45-61)."""
    tw = 0.1
    raw = 2.0 * p - 1.0
    edge = 1.0 - tw / 2.0
    t = (p - edge) / (tw / 2.0)
    smoothed = -1.0 + (1.0 - t * t) * (raw + 1.0)
    return jnp.where(p > edge, smoothed, raw)


_NAIVE_WAVEFORMS = {
    "sine": _naive_sine,
    "square": _naive_square,
    "saw": _naive_saw,
}


class Oscillator(Node):
    """Naive waveform oscillator (reference oscillators/mod.rs:7-76)."""

    INPUTS = (value("frequency", 440.0), stream("frequency_mod", 0.0),
              value("amplitude", 1.0))
    OUTPUTS = (stream("output"),)

    def __init__(self, frequency: float = 440.0, amplitude: float = 1.0,
                 waveform: str = "sine"):
        self.frequency = float(frequency)
        self.amplitude = float(amplitude)
        if waveform not in _NAIVE_WAVEFORMS:
            raise ValueError(f"unknown waveform {waveform!r}")
        self.waveform = waveform
        self.INPUTS = (value("frequency", self.frequency),
                       stream("frequency_mod", 0.0),
                       value("amplitude", self.amplitude))

    @classmethod
    def sine(cls, frequency: float, amplitude: float) -> "Oscillator":
        return cls(frequency, amplitude, "sine")

    @classmethod
    def square(cls, frequency: float, amplitude: float) -> "Oscillator":
        return cls(frequency, amplitude, "square")

    @classmethod
    def saw(cls, frequency: float, amplitude: float) -> "Oscillator":
        return cls(frequency, amplitude, "saw")

    def init_state(self, sr: SampleRate):
        return {"phase": jnp.float32(0.0)}

    def tick(self, state, ins, sr):
        frequency = ins["frequency"] * (1.0 + ins["frequency_mod"])
        modulated = _rust_rem(state["phase"])
        out = _NAIVE_WAVEFORMS[self.waveform](modulated) * ins["amplitude"]
        phase = state["phase"] + frequency / sr.hz
        phase = _rust_rem(phase)
        return {"phase": phase}, {"output": out}

    def process_block(self, state, ins, events, sr, block_len):
        dt = ins["frequency"] * (1.0 + ins["frequency_mod"]) / sr.hz
        # Reference keeps phase in (-1, 1) via truncated remainder; for the
        # non-negative-frequency case floor- and trunc-wrap coincide and the
        # sequential-exact scan is bit-identical to the per-sample tick
        # (and therefore block-size invariant).
        before, carry = exact_wrapped_phase(state["phase"], dt)
        out = _NAIVE_WAVEFORMS[self.waveform](_rust_rem(before))
        return ({"phase": carry},
                {"output": out * ins["amplitude"]})


# --------------------------------------------------------------------- #
# PolyBLEP oscillator (reference oscillators/mod.rs:86-233)
# --------------------------------------------------------------------- #
def poly_blep(t, dt):
    """Branchless polyBLEP residual (reference :139-153)."""
    safe = jnp.maximum(dt, F32_EPS)
    x0 = t / safe
    lo = x0 + x0 - x0 * x0 - 1.0
    x1 = (t - 1.0) / safe
    hi = x1 * x1 + x1 + x1 + 1.0
    r = jnp.where(t < dt, lo, jnp.where(t > 1.0 - dt, hi, 0.0))
    return jnp.where(dt <= F32_EPS, 0.0, r)


def poly_blamp(t, dt):
    """Branchless polyBLAMP residual (reference :155-169)."""
    safe = jnp.maximum(dt, F32_EPS)
    x0 = t / safe - 1.0
    lo = -(x0 * x0 * x0) / 3.0
    x1 = (t - 1.0) / safe + 1.0
    hi = (x1 * x1 * x1) / 3.0
    r = jnp.where(t < dt, lo, jnp.where(t > 1.0 - dt, hi, 0.0))
    return jnp.where(dt <= F32_EPS, 0.0, r)


class PolyBlepOscillator(Node):
    """Anti-aliased oscillator with polyBLEP/polyBLAMP residuals."""

    WAVEFORMS = ("sine", "saw", "square", "triangle")

    OUTPUTS = (stream("output"),)

    def __init__(self, frequency: float = 440.0, amplitude: float = 1.0,
                 waveform: str = "sine"):
        if waveform not in self.WAVEFORMS:
            raise ValueError(f"unknown waveform {waveform!r}")
        self.waveform = waveform
        self.INPUTS = (stream("phase_mod", 0.0),
                       value("frequency", float(frequency)),
                       stream("frequency_mod", 0.0),
                       value("amplitude", float(amplitude)),
                       value("pulse_width", 0.5))

    @classmethod
    def sine(cls, frequency: float, amplitude: float):
        return cls(frequency, amplitude, "sine")

    @classmethod
    def saw(cls, frequency: float, amplitude: float):
        return cls(frequency, amplitude, "saw")

    @classmethod
    def square(cls, frequency: float, amplitude: float):
        return cls(frequency, amplitude, "square")

    @classmethod
    def triangle(cls, frequency: float, amplitude: float):
        return cls(frequency, amplitude, "triangle")

    def init_state(self, sr: SampleRate):
        return {"phase": jnp.float32(0.0)}

    def _synthesize(self, phase, dt, pulse_width, frequency, sr_hz):
        """Waveform value at ``phase`` (already wrapped) — the body of the
        reference's match (oscillators/mod.rs:194-224)."""
        wf = self.waveform
        if wf == "sine":
            val = jnp.sin(phase * TAU)
        elif wf == "saw":
            val = 2.0 * phase - 1.0 - poly_blep(phase, dt)
        elif wf == "square":
            y = jnp.where(phase < pulse_width, 1.0, -1.0)
            y = y + poly_blep(phase, dt)
            t2 = _wrap_phase(phase + 1.0 - pulse_width)
            val = y - poly_blep(t2, dt)
        else:  # triangle
            y = 4.0 * phase
            y = jnp.where(y >= 3.0, y - 4.0, jnp.where(y > 1.0, 2.0 - y, y))
            t1 = _wrap_phase(phase + 0.25)
            t2 = _wrap_phase(phase + 0.75)
            val = y + 4.0 * dt * (poly_blamp(t1, dt) - poly_blamp(t2, dt))
        if wf != "sine":
            # Falls back to sine above sr/4 (reference :194).
            val = jnp.where(frequency >= sr_hz * 0.25,
                            jnp.sin(phase * TAU), val)
        return val

    def _frame(self, phase_carry, ins, sr_hz):
        frequency = jnp.maximum(
            ins["frequency"] * (1.0 + ins["frequency_mod"]), 0.0)
        pulse_width = jnp.clip(ins["pulse_width"], 0.0001, 0.9999)
        phase = _wrap_phase(phase_carry + ins["phase_mod"])
        fps = frequency / max(sr_hz, F32_EPS)
        dt = jnp.minimum(fps, 1.0)
        val = self._synthesize(phase, dt, pulse_width, frequency, sr_hz)
        return val * ins["amplitude"], fps

    def tick(self, state, ins, sr):
        out, fps = self._frame(state["phase"], ins, sr.hz)
        phase = _wrap_phase(state["phase"] + fps)
        return {"phase": phase}, {"output": out}

    def process_block(self, state, ins, events, sr, block_len):
        frequency = jnp.maximum(
            ins["frequency"] * (1.0 + ins["frequency_mod"]), 0.0)
        fps = frequency / max(sr.hz, F32_EPS)
        carry_before, carry = exact_wrapped_phase(state["phase"], fps)
        pulse_width = jnp.clip(ins["pulse_width"], 0.0001, 0.9999)
        phase = _wrap_phase(carry_before + ins["phase_mod"])
        dt = jnp.minimum(fps, 1.0)
        val = self._synthesize(phase, dt, pulse_width, frequency, sr.hz)
        return ({"phase": carry}, {"output": val * ins["amplitude"]})

    def process_block_batched(self, state, ins, events, sr, block_len):
        """All voices at once with EXACT per-sample phase wrapping: one
        lane-parallel kernel accumulates the phases (bit-parity with
        tick; the prefix-sum form drifts ~1e-3 RMS/s), then the polyBLEP
        synthesis runs time-parallel on the exact phases."""
        from ..ops.pallas.util import pallas_mode
        use, _ = pallas_mode()
        if not use:
            return None

        frequency = jnp.maximum(
            ins["frequency"] * (1.0 + ins["frequency_mod"]), 0.0)  # [C,B]
        fps = frequency / max(sr.hz, F32_EPS)
        before, carry = exact_wrapped_phase(state["phase"],
                                            jnp.moveaxis(fps, 0, 1))
        before = jnp.moveaxis(before, 0, 1)  # [C, B]
        pulse_width = jnp.clip(ins["pulse_width"], 0.0001, 0.9999)
        phase = _wrap_phase(before + ins["phase_mod"])
        dt = jnp.minimum(fps, 1.0)
        val = self._synthesize(phase, dt, pulse_width, frequency, sr.hz)
        return ({"phase": carry}, {"output": val * ins["amplitude"]})
