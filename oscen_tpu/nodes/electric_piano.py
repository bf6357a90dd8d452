"""Electric-piano voice nodes.

Counterparts of the reference example's additive voice
(/root/reference/examples/electric-piano/src/electric_piano_voice.rs):

- :class:`OscillatorBank` — 32 sine harmonics via complex rotation
  (one complex multiply per harmonic per sample instead of 32 ``sin`` calls,
  :79-170).  Block mode closes the rotation into ``sin/cos`` of per-sample
  angles — a dense ``[B, 32]`` evaluation.
- :class:`AmplitudeSource` — per-harmonic decay/release envelopes updated
  every 64 samples with linear interpolation between updates (:173-356).
  The geometric-times-linear structure telescopes to a closed form
  ``C0 * m^n * (1 - (j/64)(1-m))`` over the 65-tick cycle, evaluated for
  the whole block at once.

The per-sample ``tick`` paths mirror the reference exactly.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import SampleRate, event, stream, value
from ..graph.node import Node, select_tree

NUM_HARMONICS = 32
INTERPOLATION_STEPS = 64
CYCLE = INTERPOLATION_STEPS + 1  # 64 interp ticks + 1 settle tick

# Reference amplitude spectra sampled from electric piano sounds
# (electric_piano_voice.rs:10-47)
VELOCITY_0_SPECTRUM = np.array(
    [0.02, 0.05] + [0.0] * 30, np.float32)

VELOCITY_127_SPECTRUM = np.array([
    0.150869, 0.385766, 0.215543, 0.117811, 0.100411, 0.0128637,
    0.0288844, 0.00243388, 0.00963092, 0.0035634, 0.00256945, 0.00184799,
    0.000399878, 0.000660576, 3.00995e-05, 0.00021866, 9.33705e-05,
    0.000177973, 0.0002545, 0.000323602, 0.000779045, 0.000116569,
    0.000772873, 0.000364486, 0.000248027, 0.00018236, 3.27292e-05,
    6.64988e-05, 0.0, 0.0, 0.0, 0.0], np.float32)

HARMONIC_NUMBERS = np.arange(1, NUM_HARMONICS + 1, dtype=np.float32)

# The per-tick blend `current = current*(1-τ_k) + target*τ_k` with
# τ_k = k/64 telescopes to current_k = target + (C0-target)·P_k where
# P_k = Π_{i=1..k} (1 - i/64).  Precomputed table over the 65-tick cycle
# (P_0 = 1 … P_64 = 0; index 64 doubles as the settle tick's factor 0).
_P_TABLE = np.ones((CYCLE,), np.float32)
_P_TABLE[1:] = np.cumprod(
    (INTERPOLATION_STEPS - np.arange(1, CYCLE, dtype=np.float32))
    / INTERPOLATION_STEPS)


def _complex_pow_tables(z_re, z_im, max_exp: int):
    """Power tables for z^e, e in [0, max_exp], split into low (e & 15)
    and high (e >> 4) factors so per-sample rotations become two gathers
    and one complex multiply instead of sin/cos — the per-element
    transcendental cost is what bounds the additive voice on the VPU."""
    def cum(zr, zi, n):
        zr_s = jnp.broadcast_to(zr, (n,) + zr.shape)
        zi_s = jnp.broadcast_to(zi, (n,) + zi.shape)

        def comb(a, b):
            ar, ai = a
            br, bi = b
            return (ar * br - ai * bi, ar * bi + ai * br)
        return jax.lax.associative_scan(comb, (zr_s, zi_s), axis=0)

    ones = jnp.ones((1,) + z_re.shape, jnp.float32)
    zeros = jnp.zeros((1,) + z_im.shape, jnp.float32)
    lo_r, lo_i = cum(z_re, z_im, 15)            # z^1..z^15
    lo_r = jnp.concatenate([ones, lo_r], axis=0)   # z^0..z^15
    lo_i = jnp.concatenate([zeros, lo_i], axis=0)
    # z^16 then (z^16)^1..^n_hi
    z16_r, z16_i = lo_r[-1] * z_re - lo_i[-1] * z_im, \
        lo_r[-1] * z_im + lo_i[-1] * z_re
    n_hi = (max_exp >> 4) + 1
    hi_r, hi_i = cum(z16_r, z16_i, n_hi)
    hi_r = jnp.concatenate([ones, hi_r], axis=0)
    hi_i = jnp.concatenate([zeros, hi_i], axis=0)
    return lo_r, lo_i, hi_r, hi_i


def _pow_gather(tables, e):
    """z^e via the split tables; ``e`` int32 [B, 1] broadcasting against
    the trailing table axes."""
    lo_r, lo_i, hi_r, hi_i = tables
    el = e & 15
    eh = e >> 4
    lr = lo_r[el[:, 0]]
    li = lo_i[el[:, 0]]
    hr = hi_r[eh[:, 0]]
    hi_ = hi_i[eh[:, 0]]
    return lr * hr - li * hi_, lr * hi_ + li * hr


class OscillatorBank(Node):
    """32-harmonic additive oscillator via complex rotation."""

    INPUTS = (value("frequency", 440.0), event("gate"),
              stream("amplitudes", 0.0, shape=(NUM_HARMONICS,)))
    OUTPUTS = (stream("output"),)

    def init_state(self, sr: SampleRate):
        return {
            "osc_re": jnp.ones((NUM_HARMONICS,), jnp.float32),
            "osc_im": jnp.zeros((NUM_HARMONICS,), jnp.float32),
            "mul_re": jnp.ones((NUM_HARMONICS,), jnp.float32),
            "mul_im": jnp.zeros((NUM_HARMONICS,), jnp.float32),
            "last_frequency": jnp.float32(0.0),
        }

    def on_gate(self, state, velocity, sr, ins):
        """Note-on resets the oscillators to zero phase (:116-123)."""
        reset = {**state,
                 "osc_re": jnp.ones_like(state["osc_re"]),
                 "osc_im": jnp.zeros_like(state["osc_im"])}
        return select_tree(velocity > 0.0, reset, state)

    @staticmethod
    def _multipliers(freq, sr_hz):
        harm_freq = freq * HARMONIC_NUMBERS
        angle = 2.0 * math.pi * harm_freq / sr_hz
        below = harm_freq < (sr_hz * 0.5)
        mul_re = jnp.where(below, jnp.cos(angle), 1.0)
        mul_im = jnp.where(below, jnp.sin(angle), 0.0)
        return mul_re, mul_im

    def tick(self, state, ins, sr):
        freq = ins["frequency"]
        changed = jnp.logical_and(
            freq > 0.0,
            jnp.abs(state["last_frequency"] - freq) >= 0.01)
        mul_re, mul_im = self._multipliers(freq, sr.hz)
        mre = jnp.where(changed, mul_re, state["mul_re"])
        mim = jnp.where(changed, mul_im, state["mul_im"])
        # frequency change resets oscillators (:158)
        ore = jnp.where(changed, 1.0, state["osc_re"])
        oim = jnp.where(changed, 0.0, state["osc_im"])
        last = jnp.where(changed, freq, state["last_frequency"])

        # rotate, then sum imag parts weighted by amplitudes (:164-170)
        nre = ore * mre - oim * mim
        nim = ore * mim + oim * mre
        out = jnp.sum(nim * ins["amplitudes"], axis=-1) * 3.0
        return ({"osc_re": nre, "osc_im": nim, "mul_re": mre,
                 "mul_im": mim, "last_frequency": last},
                {"output": out})

    def process_block(self, state, ins, events, sr, block_len):
        """Closed-form rotation: osc(k) = osc0 * e^{i(k+1)θ}, segmented at
        gate events.  The frequency is a per-block step function that can
        only change at event boundaries (MidiVoiceHandler emits frequency
        steps and gate events at the same frame), so each segment reads
        the frequency at its start sample, applying the reference's
        change-detection reset there."""
        B = block_len
        buf = events.get("gate")
        K = buf.capacity if buf is not None else 0
        t_idx = jnp.arange(B, dtype=jnp.float32)[:, None]  # [B,1]

        seg_start = jnp.float32(0.0)
        re0 = state["osc_re"]
        im0 = state["osc_im"]
        mre, mim = state["mul_re"], state["mul_im"]
        last = state["last_frequency"]
        out_im = jnp.zeros((B, NUM_HARMONICS), jnp.float32)
        for j in range(K + 1):
            # frequency at this segment's first sample
            f = jnp.take(ins["frequency"],
                         jnp.clip(seg_start, 0, B - 1).astype(jnp.int32))
            changed = jnp.logical_and(f > 0.0,
                                      jnp.abs(last - f) >= 0.01)
            n_mre, n_mim = self._multipliers(f, sr.hz)
            mre = jnp.where(changed, n_mre, mre)
            mim = jnp.where(changed, n_mim, mim)
            re0 = jnp.where(changed, 1.0, re0)
            im0 = jnp.where(changed, 0.0, im0)
            last = jnp.where(changed, f, last)

            if j < K:
                fired = jnp.logical_and(buf.valid[..., j],
                                        buf.values[..., j] > 0.0)
                end = jnp.where(buf.valid[..., j],
                                jnp.clip(buf.offsets[..., j], 0,
                                         B).astype(jnp.float32),
                                jnp.float32(B))
            else:
                end = jnp.float32(B)

            # rotation powers via split tables (two gathers + one complex
            # multiply per element, instead of per-element sin/cos)
            tables = _complex_pow_tables(mre, mim, B)
            k = t_idx - seg_start  # [B,1] float
            e = jnp.clip(k + 1.0, 0.0, float(B)).astype(jnp.int32)
            wr, wi = _pow_gather(tables, e)  # [B, H]
            seg_im = re0[None, :] * wi + im0[None, :] * wr
            mask = jnp.logical_and(t_idx >= seg_start, t_idx < end)
            out_im = jnp.where(mask, seg_im, out_im)
            # state at segment end
            n_seg = jnp.maximum(end - seg_start, 0.0)
            er, ei = _pow_gather(
                tables, jnp.reshape(n_seg.astype(jnp.int32), (1, 1)))
            end_re = jnp.where(n_seg > 0, re0 * er[0] - im0 * ei[0], re0)
            end_im = jnp.where(n_seg > 0, re0 * ei[0] + im0 * er[0], im0)
            if j < K:
                # gate-on at `end` resets phase before that sample runs
                re0 = jnp.where(fired, jnp.ones_like(end_re), end_re)
                im0 = jnp.where(fired, jnp.zeros_like(end_im), end_im)
                seg_start = end
            else:
                re0, im0 = end_re, end_im

        out = jnp.sum(out_im * ins["amplitudes"], axis=-1) * 3.0
        return ({"osc_re": re0, "osc_im": im0, "mul_re": mre,
                 "mul_im": mim, "last_frequency": last},
                {"output": out})


def _get_decay(note, decay_rate, harmonic_decay, key_scaling):
    """Per-harmonic hold-phase decay multipliers (:232-255)."""
    base = (100.0 - decay_rate) / 40000.0
    harmonic_scaling = 1.0 - ((100.0 - harmonic_decay) / 200000.0)
    scaling_multiplier = (48.0 - note) / 12.0
    ks = scaling_multiplier * (key_scaling * 0.02)
    adjusted = jnp.where(ks > 0.0,
                         1.0 - (base / (1.0 + ks)),
                         1.0 - (base * (1.0 - ks)))
    scaling = jnp.power(harmonic_scaling,
                        jnp.arange(NUM_HARMONICS, dtype=jnp.float32))
    return adjusted * scaling


def _get_release(release_rate):
    """(:257-261)"""
    rel = 0.999 - ((100.0 - release_rate) / 1000.0)
    return jnp.full((NUM_HARMONICS,), 1.0, jnp.float32) * rel


def _initial_amplitudes(velocity, brightness, velocity_scaling):
    """(:263-280)"""
    amps = (jnp.asarray(VELOCITY_127_SPECTRUM) * velocity
            + jnp.asarray(VELOCITY_0_SPECTRUM) * (1.0 - velocity))
    b = -0.2 + (0.8 * (brightness * 0.01))
    b = b + velocity * velocity_scaling * 0.01 * 0.5
    idx = jnp.arange(NUM_HARMONICS, dtype=jnp.float32)
    return amps * (1.0 + b * idx)


class AmplitudeSource(Node):
    """Per-harmonic envelope source with 64-sample interpolation cycles."""

    INPUTS = (value("frequency", 440.0), event("gate"),
              value("brightness", 30.0), value("velocity_scaling", 50.0),
              value("decay_rate", 90.0), value("harmonic_decay", 70.0),
              value("key_scaling", 50.0), value("release_rate", 40.0))
    OUTPUTS = (stream("amplitudes", shape=(NUM_HARMONICS,)),)

    NOTE_PITCH = 60.0  # reference keeps note_pitch at its ctor value

    def init_state(self, sr: SampleRate):
        z = jnp.zeros((NUM_HARMONICS,), jnp.float32)
        return {"current": z, "target": z,
                "decay": z, "release": z,
                "released": jnp.bool_(False),
                "velocity": jnp.float32(0.0),
                "step": jnp.int32(INTERPOLATION_STEPS)}

    def on_gate(self, state, velocity, sr, ins):
        """trigger_note / release_note (:282-305)."""
        trig = {**state,
                "velocity": velocity,
                "decay": _get_decay(self.NOTE_PITCH, ins["decay_rate"],
                                    ins["harmonic_decay"],
                                    ins["key_scaling"]),
                "release": _get_release(ins["release_rate"]),
                "current": _initial_amplitudes(velocity, ins["brightness"],
                                               ins["velocity_scaling"]),
                "released": jnp.bool_(False),
                "step": jnp.int32(0)}
        rel = {**state, "released": jnp.bool_(True),
               "step": jnp.int32(0)}
        return select_tree(velocity > 0.0, trig, rel)

    def tick(self, state, ins, sr):
        step = state["step"]
        mult = jnp.where(state["released"], state["release"],
                         state["decay"])
        target = jnp.where(step == 0, state["current"] * mult,
                           state["target"])
        interp = step < INTERPOLATION_STEPS
        tau = (step + 1).astype(jnp.float32) / INTERPOLATION_STEPS
        cur_i = state["current"] * (1.0 - tau) + target * tau
        current = jnp.where(interp, cur_i, target)
        new_step = jnp.where(interp, step + 1, 0)
        st = {**state, "current": current, "target": target,
              "step": new_step}
        return st, {"amplitudes": current}

    def process_block(self, state, ins, events, sr, block_len):
        """Closed form over the 65-tick cycle: within cycle n at interp
        step j, current = C0 * m^n * (1 - (j/64)(1-m)); the settle tick
        (j == 0 after wrap) holds the cycle-end value."""
        B = block_len
        t_idx = jnp.arange(B, dtype=jnp.float32)[:, None]  # [B,1]
        buf = events.get("gate")
        K = buf.capacity if buf is not None else 0

        P = jnp.asarray(_P_TABLE)

        def cycle_factor(m, jj):
            """m + (1-m)·P_j — the within-cycle blend factor (j int)."""
            pj = jnp.take(P, jj.astype(jnp.int32), axis=0)
            return m + (1.0 - m) * pj

        def c_base_of(st, m):
            """Reconstruct the cycle-base value from a mid-cycle state."""
            frac0 = cycle_factor(m, st["step"])
            return st["current"] / jnp.maximum(frac0, 1e-30)

        n_max = (INTERPOLATION_STEPS + B) // CYCLE + 2

        def m_pow_table(m):
            """m^0..m^n_max via a short scan — replaces per-element
            exp(n log m) (the transcendental cost dominates the VPU)."""
            ms = jnp.broadcast_to(m, (n_max,) + m.shape)
            cums = jax.lax.associative_scan(jnp.multiply, ms, axis=0)
            return jnp.concatenate([jnp.ones((1,) + m.shape, jnp.float32),
                                    cums], axis=0)

        def seg_eval(st, k):
            """amplitudes after k+1 ticks from state st (k [B,1] >= 0)."""
            m = jnp.where(st["released"], st["release"], st["decay"])
            c_base = c_base_of(st, m)
            a = st["step"].astype(jnp.float32) + k + 1.0
            n = jnp.floor(a / CYCLE)
            jj = a - n * CYCLE
            table = m_pow_table(m)
            mn = table[jnp.clip(n.astype(jnp.int32), 0, n_max)[:, 0]] \
                if n.ndim == 2 else table[jnp.clip(
                    n.astype(jnp.int32), 0, n_max)]
            return c_base * mn * cycle_factor(m, jj)

        def seg_end_state(st, n_ticks):
            """state after n_ticks (dynamic scalar)."""
            cur = seg_eval(st, jnp.reshape(n_ticks.astype(jnp.float32)
                                           - 1.0, (1, 1)))[0]
            s0 = st["step"].astype(jnp.float32)
            a = s0 + n_ticks.astype(jnp.float32)
            nn = jnp.floor(a / CYCLE)
            new_step = a - nn * CYCLE
            m = jnp.where(st["released"], st["release"], st["decay"])
            tgt = c_base_of(st, m) * jnp.exp(
                (nn + 1.0) * jnp.log(jnp.maximum(m, 1e-30)))
            new = {**st, "current": cur, "target": tgt,
                   "step": new_step.astype(jnp.int32)}
            return select_tree(n_ticks > 0, new, st)

        amps = jnp.zeros((B, NUM_HARMONICS), jnp.float32)
        st = state
        start = jnp.float32(0.0)
        for j in range(K + 1):
            if j < K:
                end = jnp.where(buf.valid[..., j],
                                jnp.clip(buf.offsets[..., j], 0, B),
                                B).astype(jnp.float32)
            else:
                end = jnp.float32(B)
            lv = seg_eval(st, jnp.maximum(t_idx - start, 0.0))
            mask = jnp.logical_and(t_idx >= start, t_idx < end)
            amps = jnp.where(mask, lv, amps)
            st = seg_end_state(st, end - start)
            if j < K:
                off = jnp.clip(buf.offsets[..., j], 0, B - 1).astype(
                    jnp.int32)
                p_ev = {k: jnp.take(v, off, axis=0)
                        for k, v in ins.items()}
                fired = jnp.logical_and(buf.valid[..., j],
                                        buf.offsets[..., j] < B)
                st = select_tree(
                    fired, self.on_gate(st, buf.values[..., j], sr, p_ev),
                    st)
                start = end
        return st, {"amplitudes": amps}


class ElectricPianoVoice(Node):
    """Fused additive voice: AmplitudeSource → OscillatorBank composed in
    one node (the reference's ElectricPianoVoiceNode subgraph,
    electric_piano_voice.rs:362-403, as a single processor).

    Event-free blocks on a GPU run the **fused Triton kernel**
    (ops/pallas/additive.py): the whole voice algorithm in closed form
    in one kernel, no [V, B, H] intermediates in device memory.  Event
    blocks and the CPU compose the two nodes' implementations.
    """

    OUTPUTS = (stream("output"),)

    def __init__(self):
        self._amp = AmplitudeSource()
        self._bank = OscillatorBank()
        self.INPUTS = self._amp.INPUTS  # frequency, gate, 6 params

    def init_state(self, sr: SampleRate):
        return {"amp": self._amp.init_state(sr),
                "bank": self._bank.init_state(sr)}

    def on_gate(self, state, velocity, sr, ins):
        return {"amp": self._amp.on_gate(state["amp"], velocity, sr, ins),
                "bank": self._bank.on_gate(state["bank"], velocity, sr,
                                           ins)}

    def _split_ins(self, ins, amps):
        bank_ins = {"frequency": ins["frequency"], "amplitudes": amps}
        return ins, bank_ins

    def tick(self, state, ins, sr):
        amp_st, amp_out = self._amp.tick(state["amp"], ins, sr)
        bank_ins = {"frequency": ins["frequency"],
                    "amplitudes": amp_out["amplitudes"]}
        bank_st, out = self._bank.tick(state["bank"], bank_ins, sr)
        return ({"amp": amp_st, "bank": bank_st},
                {"output": out["output"]})

    def process_block(self, state, ins, events, sr, block_len):
        amp_st, amp_out = self._amp.process_block(
            state["amp"], ins, events, sr, block_len)
        bank_ins = {"frequency": ins["frequency"],
                    "amplitudes": amp_out["amplitudes"]}
        bank_st, out = self._bank.process_block(
            state["bank"], bank_ins, events, sr, block_len)
        return ({"amp": amp_st, "bank": bank_st},
                {"output": out["output"]})

    def process_block_batched(self, state, ins, events, sr, block_len,
                              fanin_eps=frozenset()):
        """All voices through ONE fused kernel (no events this block).

        When the compiler marks ``output`` as fan-in-only (its sole
        consumers sum over all voices), the mixdown is fused into the
        kernel and only partial sums of the mix leave it.  Blocks too
        small for the compiled kernel to pay take the composed closed
        forms; interpret mode (the CPU test route) runs the kernel at
        any size."""
        from ..ops.pallas.additive import kernel_pays, supported
        from ..ops.pallas.util import pallas_mode
        use, interp = pallas_mode()
        num_voices = ins["frequency"].shape[0]
        if not use or not supported(block_len) or not (
                interp or kernel_pays(num_voices, block_len)):
            return None
        with_mix = "output" in fanin_eps
        from ..graph import explain
        explain.note(kernel="additive_voice", fanin_mixdown_fused=with_mix)
        return self.kernel_block(state, ins, sr, block_len, with_mix,
                                 interp)

    def kernel_block(self, state, ins, sr, block_len, with_mix,
                     interpret=False):
        """One steady block of all voices through the fused kernel,
        whatever the size (``process_block_batched`` decides when)."""
        from ..ops.pallas.additive import additive_voice_block
        bank = state["bank"]
        amp = state["amp"]
        freq = ins["frequency"][:, 0]  # [C] (block-constant, no events)
        changed = jnp.logical_and(
            freq > 0.0, jnp.abs(bank["last_frequency"] - freq) >= 0.01)
        ch = changed[:, None]
        n_mre, n_mim = jax.vmap(
            lambda f: OscillatorBank._multipliers(f, sr.hz))(freq)
        mre = jnp.where(ch, n_mre, bank["mul_re"])
        mim = jnp.where(ch, n_mim, bank["mul_im"])
        ore = jnp.where(ch, 1.0, bank["osc_re"])
        oim = jnp.where(ch, 0.0, bank["osc_im"])
        last = jnp.where(changed, freq, bank["last_frequency"])

        mult = jnp.where(amp["released"][:, None], amp["release"],
                         amp["decay"])
        y, or_o, oi_o, cur_o, tgt_o, step_o = additive_voice_block(
            ore.T, oim.T, mre.T, mim.T,
            amp["current"].T, amp["target"].T, mult.T,
            amp["step"], block_len, with_mix=with_mix, interpret=interpret)
        new_state = {
            "bank": {**bank, "osc_re": or_o.T, "osc_im": oi_o.T,
                     "mul_re": mre, "mul_im": mim,
                     "last_frequency": last},
            "amp": {**amp, "current": cur_o.T, "target": tgt_o.T,
                    "step": step_o.astype(jnp.int32)},
        }
        if with_mix:
            return new_state, {"__fanin__output": y}  # [B], pre-summed
        return new_state, {"output": y.T}
