"""ADSR envelope.

Port of the reference's gate-event-driven ADSR
(/root/reference/oscen-lib/src/envelope/adsr.rs): one-pole exponential
attack/decay with coefficient ``1 - exp(-4.605/n)`` (99% at stage end, then
snap), linear release (slope recomputed each sample from the current level,
which telescopes to an exact line), velocity-scaled sustain and
zero-attack/zero-release shortcuts.

The per-sample state machine is fully branchless: the stage is an int32 code
and every branch of the reference's ``match`` is computed and selected with
``where`` — identical math per voice, vectorizable across voices and (in the
sample-mode compiler) scheduled exactly like the reference.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.types import SampleRate, event, stream, value
from ..graph.node import Node

MIN_TIME_SECONDS = 1.0e-5
CURVE_TIME_CONSTANT = 4.6051702  # -ln(0.01)

IDLE, ATTACK, DECAY, SUSTAIN, RELEASE = range(5)


def _cached_steps(ins, sr_hz: float):
    """attack/decay/release stage lengths + one-pole coefficients
    (reference adsr.rs:117-134).  Pure function of this sample's params."""
    sr = max(float(sr_hz), 1.0)
    def n_samples(t):
        n = (jnp.maximum(t, MIN_TIME_SECONDS) * sr).astype(jnp.int32)
        return jnp.maximum(n, 1)
    a_n = n_samples(ins["attack"])
    d_n = n_samples(ins["decay"])
    r_n = n_samples(ins["release"])
    a_c = 1.0 - jnp.exp(-CURVE_TIME_CONSTANT / a_n.astype(jnp.float32))
    d_c = 1.0 - jnp.exp(-CURVE_TIME_CONSTANT / d_n.astype(jnp.float32))
    return a_n, d_n, r_n, a_c, d_c


def _release_increment(stage, rem, level):
    """Linear slope landing at zero (reference adsr.rs:160-173)."""
    current = jnp.clip(level, 0.0, 1.0)
    inc = jnp.where(current <= 0.0, 0.0,
                    -current / jnp.maximum(rem, 1).astype(jnp.float32))
    return jnp.where(jnp.logical_or(rem == 0, stage != RELEASE), 0.0, inc)


def _update_sustain_level(state, ins, velocity, sr_hz):
    """update_sustain_level (reference adsr.rs:92-115)."""
    sus = jnp.clip(ins["sustain"] * velocity, 0.0, 1.0)
    a_n, d_n, r_n, _, _ = _cached_steps(ins, sr_hz)
    stage = state["stage"]
    rem = state["rem"]
    has_rem = rem > 0
    cap = jnp.where(stage == ATTACK, a_n,
                    jnp.where(stage == DECAY, d_n,
                              jnp.where(stage == RELEASE, r_n, rem)))
    clamped = jnp.maximum(jnp.minimum(rem, cap), 1)
    in_timed = jnp.logical_or(stage == ATTACK,
                              jnp.logical_or(stage == DECAY,
                                             stage == RELEASE))
    rem = jnp.where(jnp.logical_and(in_timed, has_rem), clamped, rem)
    target = jnp.where(jnp.logical_or(stage == DECAY, stage == SUSTAIN), sus,
                       jnp.where(stage == RELEASE, 0.0, state["target"]))
    # keep the absolute-time bookkeeping consistent: stage_len = age + rem
    # whenever rem was (possibly) clamped by a parameter change
    stage_len = jnp.where(jnp.logical_and(in_timed, has_rem),
                          state["age"] + rem, state["stage_len"])
    new = {**state, "sustain_level": sus, "velocity": velocity,
           "rem": rem, "target": target, "stage_len": stage_len}
    inc = jnp.where(stage == RELEASE,
                    _release_increment(stage, rem, state["level"]),
                    state["release_inc"])
    new["release_inc"] = inc
    return new


def _set_stage(state, ins, stage_code, target, sr_hz):
    """set_stage (reference adsr.rs:136-158).  Stage lengths are always
    >= 1 (recalculate forces max(1)), so the zero-sample recursion path is
    unreachable here; the zero-attack shortcut is handled in on_gate."""
    a_n, d_n, r_n, _, _ = _cached_steps(ins, sr_hz)
    samples = jnp.where(stage_code == ATTACK, a_n,
                        jnp.where(stage_code == DECAY, d_n,
                                  jnp.where(stage_code == RELEASE, r_n, 0)))
    target = jnp.clip(target, 0.0, 1.0)
    st = {**state, "stage": jnp.int32(stage_code) + jnp.int32(0),
          "target": target, "rem": samples,
          "entry_level": state["level"],
          "age": jnp.int32(0),
          "stage_len": samples}
    st["release_inc"] = _release_increment(st["stage"], samples,
                                           st["level"])
    return st


class AdsrEnvelope(Node):
    INPUTS = (event("gate"), value("attack", 0.01), value("decay", 0.1),
              value("sustain", 0.7), value("release", 0.3))
    OUTPUTS = (stream("output"),)

    def __init__(self, attack: float = 0.01, decay: float = 0.1,
                 sustain: float = 0.7, release: float = 0.3):
        self.INPUTS = (event("gate"),
                       value("attack", float(attack)),
                       value("decay", float(decay)),
                       value("sustain", float(sustain)),
                       value("release", float(release)))
        self._sustain0 = float(min(max(sustain, 0.0), 1.0))

    def init_state(self, sr: SampleRate):
        return {
            "stage": jnp.int32(IDLE),
            "rem": jnp.int32(0),
            "level": jnp.float32(0.0),
            "target": jnp.float32(0.0),
            "sustain_level": jnp.float32(self._sustain0),
            "velocity": jnp.float32(1.0),
            "release_inc": jnp.float32(0.0),
            # absolute-time bookkeeping for the block-mode closed forms:
            # level at stage entry, ticks since stage entry, stage length.
            # Closed forms evaluated from these are pure functions of the
            # absolute sample index — block-size invariant by construction.
            "entry_level": jnp.float32(0.0),
            "age": jnp.int32(0),
            "stage_len": jnp.int32(0),
        }

    # ------------------------------------------------------------------ #
    def on_gate(self, state, velocity, sr, ins):
        """handle_gate_event (reference adsr.rs:250-273)."""
        sr_hz = sr.hz

        # --- gate ON path ---
        vel = jnp.clip(velocity, 0.0, 1.0)
        on = _update_sustain_level(state, ins, vel, sr_hz)
        # zero-attack shortcut: level=1, straight to decay
        shortcut = {**on, "level": jnp.float32(1.0)}
        shortcut = _set_stage(shortcut, ins, DECAY, on["sustain_level"],
                              sr_hz)
        normal = _set_stage(on, ins, ATTACK, 1.0, sr_hz)
        on_state = _sel(ins["attack"] <= MIN_TIME_SECONDS, shortcut, normal)

        # --- gate OFF path ---
        idle = {**state, "stage": jnp.int32(IDLE),
                "level": jnp.float32(0.0), "rem": jnp.int32(0),
                "release_inc": jnp.float32(0.0),
                "entry_level": jnp.float32(0.0),
                "age": jnp.int32(0), "stage_len": jnp.int32(0)}
        rel = _set_stage(state, ins, RELEASE, 0.0, sr_hz)
        off_state = _sel(ins["release"] <= MIN_TIME_SECONDS, idle, rel)

        return _sel(velocity > 0.0, on_state, off_state)

    # ------------------------------------------------------------------ #
    def tick(self, state, ins, sr):
        sr_hz = sr.hz
        # apply_parameters (reference adsr.rs:84-90): clamp params, then
        # update_sustain_level with the *current* velocity.
        params = {**ins,
                  "attack": jnp.maximum(ins["attack"], 0.0),
                  "decay": jnp.maximum(ins["decay"], 0.0),
                  "sustain": jnp.clip(ins["sustain"], 0.0, 1.0),
                  "release": jnp.maximum(ins["release"], 0.0)}
        st = _update_sustain_level(state, params, state["velocity"], sr_hz)

        a_n, d_n, r_n, a_c, d_c = _cached_steps(params, sr_hz)
        stage, rem, level = st["stage"], st["rem"], st["level"]
        sus = st["sustain_level"]

        # --- attack ---
        att_level = jnp.clip(level + (1.0 - level) * a_c, 0.0, 1.0)
        att_rem = rem - 1
        att_active = jnp.logical_and(stage == ATTACK, rem > 0)
        # completion: rem hits 0 → level=1, set Decay
        att_done = jnp.logical_and(stage == ATTACK,
                                   jnp.where(rem > 0, att_rem, rem) == 0)

        # --- decay ---
        dec_level = jnp.clip(level + (sus - level) * d_c, 0.0, 1.0)
        dec_rem = rem - 1
        dec_active = jnp.logical_and(stage == DECAY, rem > 0)
        dec_done = jnp.logical_and(stage == DECAY,
                                   jnp.where(rem > 0, dec_rem, rem) == 0)

        # --- release ---
        rel_level = jnp.clip(level + st["release_inc"], 0.0, 1.0)
        rel_rem = rem - 1
        rel_active = jnp.logical_and(stage == RELEASE, rem > 0)
        rel_done = jnp.logical_and(stage == RELEASE,
                                   jnp.where(rem > 0, rel_rem, rem) == 0)

        level = jnp.where(att_active, att_level,
                 jnp.where(dec_active, dec_level,
                  jnp.where(rel_active, rel_level,
                   jnp.where(stage == SUSTAIN, sus,
                    jnp.where(stage == IDLE, 0.0, level)))))
        rem = jnp.where(att_active, att_rem,
               jnp.where(dec_active, dec_rem,
                jnp.where(rel_active, rel_rem, rem)))

        # completions (reference complete_stage, adsr.rs:175-204)
        level = jnp.where(att_done, 1.0, level)
        level = jnp.where(dec_done, sus, level)
        level = jnp.where(rel_done, 0.0, level)
        # attack completion chains into set_stage(Decay, sustain): rem=d_n,
        # release_inc recomputed (stage Decay → 0).
        new_stage = jnp.where(att_done, DECAY,
                     jnp.where(dec_done, SUSTAIN,
                      jnp.where(rel_done, IDLE, stage))).astype(jnp.int32)
        rem = jnp.where(att_done, d_n,
               jnp.where(jnp.logical_or(dec_done, rel_done), 0, rem))
        release_inc = jnp.where(
            jnp.logical_or(att_done, jnp.logical_or(dec_done, rel_done)),
            0.0, st["release_inc"])
        target = jnp.where(att_done, jnp.clip(sus, 0.0, 1.0),
                           st["target"])

        # absolute-time bookkeeping (used by the block-mode closed forms)
        stepped = jnp.logical_or(att_active,
                                 jnp.logical_or(dec_active, rel_active))
        any_done = jnp.logical_or(att_done,
                                  jnp.logical_or(dec_done, rel_done))
        age = jnp.where(stepped, st["age"] + 1, st["age"])
        age = jnp.where(any_done, 0, age).astype(jnp.int32)
        entry = jnp.where(att_done, jnp.float32(1.0),
                 jnp.where(dec_done, sus,
                  jnp.where(rel_done, 0.0, st["entry_level"])))
        stage_len = jnp.where(att_done, d_n,
                     jnp.where(jnp.logical_or(dec_done, rel_done), 0,
                               st["stage_len"])).astype(jnp.int32)

        out_state = {**st, "stage": new_stage, "rem": rem, "level": level,
                     "target": target, "release_inc": release_inc,
                     "entry_level": entry, "age": age,
                     "stage_len": stage_len}
        return out_state, {"output": level}


    # ------------------------------------------------------------------ #
    # block mode: segment-wise closed forms (SURVEY §5.7 — "ADSR =
    # segment-wise closed-form exponentials between gate events")
    # ------------------------------------------------------------------ #
    def process_block(self, state, ins, events, sr, block_len):
        """Closed-form evaluation: the one-pole attack/decay and linear
        release telescope to exact exponentials/lines, so the whole block
        evaluates in O(1) depth.  Gate events split the block into K+1
        segments with dynamic boundaries handled by per-sample masking.

        Assumes block-constant ADSR parameters for the stage-length math
        (values at each segment start); the sustain level itself follows
        per-sample parameter changes.  The per-sample ``tick`` (sample
        mode) is the exact-cadence reference path.
        """
        B = block_len
        buf = events.get("gate")
        k_events = buf.capacity if buf is not None else 0
        t_idx = jnp.arange(B, dtype=jnp.float32)

        def pw(one_minus_c, e):
            # (1-c)^e via exp/log; c<1 guaranteed by construction
            return jnp.exp(e * jnp.log(jnp.maximum(one_minus_c, 1e-30)))

        def seg_params(off):
            """Params at a (dynamic) sample offset."""
            off = jnp.clip(off, 0, B - 1).astype(jnp.int32)
            return {k: jnp.take(v, off, axis=0) for k, v in ins.items()}

        def consts(p):
            a_n, d_n, r_n, a_c, d_c = _cached_steps(
                {k: jnp.maximum(v, 0.0) if k != "sustain"
                 else jnp.clip(v, 0.0, 1.0) for k, v in p.items()}, sr.hz)
            return (a_n.astype(jnp.float32), d_n.astype(jnp.float32),
                    r_n.astype(jnp.float32), a_c, d_c)

        def seg_levels(st, p, k):
            """Level after k+1 ticks into the segment (k may be an array;
            negative values are masked by the caller).

            Closed forms are *stage-entry-based*: pure functions of the
            absolute tick count since stage entry (``age + k + 1``) and the
            level at stage entry.  Integer positions are exact in f32, so
            the same absolute sample index yields the bit-identical level no
            matter where block/segment boundaries fall — block-size
            invariance by construction (tests/block_processing_test.rs
            property)."""
            a_n, d_n, r_n, a_c, d_c = consts(p)
            sus = jnp.clip(p["sustain"] * st["velocity"], 0.0, 1.0)
            ln = jnp.maximum(st["stage_len"].astype(jnp.float32), 0.0)
            entry = st["entry_level"]
            tau = (st["age"].astype(jnp.float32) + k) + 1.0

            # ATTACK: toward 1, snap at stage end; then DECAY for d_n; SUS
            att = 1.0 - (1.0 - entry) * pw(1.0 - a_c, tau)
            att = jnp.where(tau >= ln, 1.0, att)
            u = tau - ln  # decay steps after attack end (entry level 1.0)
            # one decay power sweep serves both the post-attack decay and
            # the DECAY stage (exponent selected per stage)
            stage = st["stage"]
            pd = pw(1.0 - d_c, jnp.where(stage == ATTACK, u, tau))
            att_dec = sus + (1.0 - sus) * pd
            att_dec = jnp.where(u >= d_n, sus, att_dec)
            attack_lv = jnp.where(tau <= ln, att,
                                  jnp.where(u <= d_n, att_dec, sus))

            # DECAY: toward sus, snap at stage end; then SUSTAIN
            dec = sus + (entry - sus) * pd
            decay_lv = jnp.where(tau >= ln, sus, dec)

            # RELEASE: linear from entry level to 0 over the stage length
            rel = entry * jnp.maximum(ln - tau, 0.0) / jnp.maximum(ln, 1.0)
            release_lv = jnp.where(tau >= ln, 0.0, rel)

            stage = st["stage"]
            lv = jnp.where(stage == ATTACK, attack_lv,
                  jnp.where(stage == DECAY, decay_lv,
                   jnp.where(stage == RELEASE, release_lv,
                    jnp.where(stage == SUSTAIN, sus, 0.0))))
            return jnp.clip(lv, 0.0, 1.0)

        def seg_end_state(st, p, n):
            """State after n ticks (n dynamic scalar >= 0).  All stage
            bookkeeping is exact int32 arithmetic on absolute positions."""
            a_n, d_n, r_n, a_c, d_c = consts(p)
            d_ni = d_n.astype(jnp.int32)
            sus = jnp.clip(p["sustain"] * st["velocity"], 0.0, 1.0)
            ln = st["stage_len"]
            nf = n.astype(jnp.float32)
            lvl_end = jnp.where(nf > 0, seg_levels(st, p, nf - 1.0),
                                st["level"])
            stage = st["stage"]
            tau_end = st["age"] + n  # int32, exact

            in_stage = tau_end < ln
            att_in_decay = jnp.logical_and(tau_end >= ln,
                                           tau_end - ln < d_ni)
            new_stage = jnp.where(
                stage == ATTACK,
                jnp.where(in_stage, ATTACK,
                          jnp.where(att_in_decay, DECAY, SUSTAIN)),
                jnp.where(
                    stage == DECAY,
                    jnp.where(in_stage, DECAY, SUSTAIN),
                    jnp.where(stage == RELEASE,
                              jnp.where(in_stage, RELEASE, IDLE),
                              stage))).astype(jnp.int32)
            new_age = jnp.where(
                stage == ATTACK,
                jnp.where(in_stage, tau_end,
                          jnp.where(att_in_decay, tau_end - ln, 0)),
                jnp.where(jnp.logical_and(
                    jnp.logical_or(stage == DECAY, stage == RELEASE),
                    in_stage), tau_end, 0)).astype(jnp.int32)
            new_len = jnp.where(
                stage == ATTACK,
                jnp.where(in_stage, ln,
                          jnp.where(att_in_decay, d_ni, 0)),
                jnp.where(jnp.logical_and(
                    jnp.logical_or(stage == DECAY, stage == RELEASE),
                    in_stage), ln, 0)).astype(jnp.int32)
            new_entry = jnp.where(
                jnp.logical_and(stage == ATTACK, att_in_decay),
                jnp.float32(1.0),
                jnp.where(new_stage == SUSTAIN, sus,
                          jnp.where(new_stage == IDLE, 0.0,
                                    st["entry_level"])))
            new_rem = jnp.maximum(new_len - new_age, 0).astype(jnp.int32)
            new_state = {**st, "stage": new_stage, "rem": new_rem,
                         "level": lvl_end,
                         "sustain_level": sus,
                         "entry_level": new_entry,
                         "age": new_age, "stage_len": new_len,
                         "target": jnp.where(
                             new_stage == RELEASE, 0.0,
                             jnp.where(new_stage >= DECAY, sus,
                                       st["target"]))}
            new_state["release_inc"] = _release_increment(
                new_stage, new_state["rem"], lvl_end)
            return _sel(n > 0, new_state, st)

        levels = jnp.zeros((B,), jnp.float32)
        st = state
        start = jnp.int32(0)
        for j in range(k_events + 1):
            if j < k_events:
                valid_j = buf.valid[..., j]
                end = jnp.where(valid_j,
                                jnp.clip(buf.offsets[..., j], 0, B),
                                B).astype(jnp.int32)
            else:
                end = jnp.int32(B)
            p = seg_params(start)
            k_rel = t_idx - start.astype(jnp.float32)
            lv = seg_levels(st, p, k_rel)
            mask = jnp.logical_and(t_idx >= start, t_idx < end)
            levels = jnp.where(mask, lv, levels)
            st = seg_end_state(st, p, (end - start).astype(jnp.int32))
            if j < k_events:
                p_ev = seg_params(end)
                fired = jnp.logical_and(buf.valid[..., j],
                                        buf.offsets[..., j] < B)
                st = _sel(fired,
                          self.on_gate(st, buf.values[..., j],
                                       sr, p_ev), st)
                start = end
        return st, {"output": levels}


class AdsrBank(Node):
    """N ADSR envelopes fused into one node (horizontal fusion).

    A synth voice typically runs several envelopes off the same gate
    (the FM voice has four: op3/op2/op1/filter — fm_voice.rs:54-63).  As
    separate node arrays each one evaluates its closed forms in its own
    XLA fusion; stacking them into a single node with a leading envelope
    axis evaluates all N at once — the PERF.md "horizontal fusion of the
    four per-voice envelope node arrays" lever.

    Semantics are exactly N independent :class:`AdsrEnvelope`s (the
    implementation vmaps the single-envelope code over the stacked axis),
    sharing one gate input; each section has its own attack/decay/
    sustain/release inputs named ``<section>_<param>`` and its own stream
    output named ``<section>``.
    """

    def __init__(self, sections):
        """``sections``: iterable of (name, attack, decay, sustain,
        release)."""
        sections = list(sections)
        if not sections:
            raise ValueError("AdsrBank needs at least one section")
        self._names = [s[0] for s in sections]
        if len(set(self._names)) != len(self._names):
            raise ValueError("duplicate section names")
        self._subs = [AdsrEnvelope(a, d, s_, r)
                      for (_, a, d, s_, r) in sections]
        ins = [event("gate")]
        for (name, a, d, s_, r) in sections:
            ins += [value(f"{name}_attack", float(a)),
                    value(f"{name}_decay", float(d)),
                    value(f"{name}_sustain", float(s_)),
                    value(f"{name}_release", float(r))]
        self.INPUTS = tuple(ins)
        self.OUTPUTS = tuple(stream(n) for n in self._names)

    def init_state(self, sr: SampleRate):
        import jax
        states = [sub.init_state(sr) for sub in self._subs]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)

    def _stack_ins(self, ins):
        return {p: jnp.stack([ins[f"{n}_{p}"] for n in self._names])
                for p in ("attack", "decay", "sustain", "release")}

    def on_gate(self, state, velocity, sr, ins):
        import jax
        sub = self._subs[0]
        return jax.vmap(lambda st, i: AdsrEnvelope.on_gate(
            sub, st, velocity, sr, i))(state, self._stack_ins(ins))

    def tick(self, state, ins, sr):
        import jax
        sub = self._subs[0]
        st, outs = jax.vmap(lambda s_, i: AdsrEnvelope.tick(sub, s_, i, sr)
                            )(state, self._stack_ins(ins))
        lv = outs["output"]
        return st, {n: lv[i] for i, n in enumerate(self._names)}

    def process_block(self, state, ins, events, sr, block_len):
        import jax
        sub = self._subs[0]
        st, outs = jax.vmap(
            lambda s_, i: AdsrEnvelope.process_block(
                sub, s_, i, events, sr, block_len)
        )(state, self._stack_ins(ins))
        lv = outs["output"]
        return st, {n: lv[i] for i, n in enumerate(self._names)}


def _sel(pred, a, b):
    import jax
    def s(x, y):
        x = jnp.asarray(x); y = jnp.asarray(y)
        p = pred
        extra = max(x.ndim, y.ndim) - jnp.ndim(p)
        if extra > 0:
            p = jnp.reshape(p, jnp.shape(p) + (1,) * extra)
        return jnp.where(p, x, y)
    return jax.tree_util.tree_map(s, a, b)
