"""FM operator chains, voice-parallel.

The FM operators' self-feedback (``prev_output * feedback`` into the
phase, reference examples/fm-synth/src/nodes/fm_operator.rs:57-77) is a
one-sample nonlinear recurrence — not reformulable as a scan.  The
chains run their per-sample step functions (the same ones the nodes'
``tick`` uses) through :func:`~.recurrence.lane_scan`, voices in lanes.

With every feedback at 0 (the reference examples' default) the only
cross-sample dependency left is the phase recurrence: the zero-feedback
paths scan only the wrapped phases and evaluate the sines and the
routing for the whole block at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..fastmath import sin_turns
from .recurrence import lane_scan


def _fract_advance(ph, dt):
    ph = ph + dt
    return ph - jnp.trunc(ph)  # Rust .fract()


def fm_chain_step(carry, xs):
    """One tick of the fm-synth operator chain op3 → route → op2 → op1
    (fm_voice.rs:119-147).  ``carry``: (ph3, ph2, ph1, prev3, prev2,
    prev1); ``xs``: (dt3, dt2, dt1, e3, e2, e1, fb3, fb2, fb1, mix) with
    the op levels folded into the envelopes (``e = env · level``)."""
    ph3, ph2, ph1, p3, p2, p1 = carry
    dt3, dt2, dt1, e3, e2, e1, fb3, fb2, fb1, mix = xs
    y3 = sin_turns(ph3 + 0.0 + p3 * fb3) * e3
    a = y3 * (1.0 - mix)
    b = y3 * mix
    y2 = sin_turns(ph2 + a + p2 * fb2) * e2
    y1 = sin_turns(ph1 + (y2 + b) + p1 * fb1) * e1
    return ((_fract_advance(ph3, dt3), _fract_advance(ph2, dt2),
             _fract_advance(ph1, dt1), y3, y2, y1), y1)


def pivot_chain_step(carry, xs):
    """One tick of the pivot operator chain (pivot_voice.rs:94-165): the
    RAW sine feeds each operator's own feedback, the enveloped/leveled
    signal drives the routing.  Same ``carry``/``xs`` layout as
    :func:`fm_chain_step` (``e1`` is ``env1 · 1.0``: vca1 has no level)."""
    ph3, ph2, ph1, p3, p2, p1 = carry
    dt3, dt2, dt1, e3, e2, e1, fb3, fb2, fb1, mix = xs
    y3 = sin_turns(ph3 + 0.0 + p3 * fb3)
    a3 = y3 * e3
    a = a3 * (1.0 - mix)
    b = a3 * mix
    y2 = sin_turns(ph2 + a + p2 * fb2)
    a2 = y2 * e2
    y1 = sin_turns(ph1 + (a2 + b) + p1 * fb1)
    return ((_fract_advance(ph3, dt3), _fract_advance(ph2, dt2),
             _fract_advance(ph1, dt1), y3, y2, y1), y1 * e1)


def _fract_step(p, dt):
    return _fract_advance(p, dt), p


def fract_phase3(phases, dt, B: int):
    """Sequential fract-wrapped phases for the 3-op chain (zero-feedback
    path).  Args: phases/dt ``[3, V]`` (dt block-constant).  Returns
    (ph3, ph2, ph1 each ``[B, V]`` pre-increment, carry ``[3, V]``) —
    bit-identical to the chain steps' phase recurrence."""
    carry, ph = lane_scan(_fract_step, phases, dt[None], length=B)
    return ph[:, 0], ph[:, 1], ph[:, 2], carry


def _fm_chain3_fast(phases, dt_rows, mix, e3, e2, e1):
    """Zero-feedback path: expressions and associations match
    :func:`fm_chain_step` (``prev*0`` adds exact zeros there); the phase
    recurrence is bit-identical, the sine/route math agrees at
    FMA-formation level (~1 ulp per op — the two programs compile
    separately)."""
    B = e3.shape[0]
    ph3, ph2, ph1, phc = fract_phase3(phases, dt_rows, B)
    mixr = mix[None, :]
    y3 = sin_turns(ph3) * e3
    a = y3 * (1.0 - mixr)
    b = y3 * mixr
    y2 = sin_turns(ph2 + a) * e2
    y1 = sin_turns(ph1 + (y2 + b)) * e1
    pv = jnp.concatenate([y3[-1:], y2[-1:], y1[-1:]], axis=0)
    return y1, phc, pv


def _pivot_chain3_fast(phases, dt_rows, mix, e3, e2, e1):
    """Pivot zero-feedback path: the RAW sine is the feedback/prev carry,
    the enveloped signal drives routing."""
    B = e3.shape[0]
    ph3, ph2, ph1, phc = fract_phase3(phases, dt_rows, B)
    mixr = mix[None, :]
    y3 = sin_turns(ph3)
    a3 = y3 * e3
    a = a3 * (1.0 - mixr)
    b = a3 * mixr
    y2 = sin_turns(ph2 + a)
    a2 = y2 * e2
    y1 = sin_turns(ph1 + (a2 + b))
    out = y1 * e1
    pv = jnp.concatenate([y3[-1:], y2[-1:], y1[-1:]], axis=0)
    return out, phc, pv


def _chain3(step, fast, phases, prevs, dt, lvl, fb, mix, env3, env2, env1,
            fb_static):
    e = (env3 * lvl[0], env2 * lvl[1], env1 * lvl[2])

    def seq():
        carry, y = lane_scan(
            step, tuple(phases) + tuple(prevs),
            (dt[0], dt[1], dt[2]) + e
            + (fb[0][None], fb[1][None], fb[2][None], mix[None]))
        return y, jnp.stack(carry[:3]), jnp.stack(carry[3:])

    if dt.shape[1] == 1:
        dt_rows = dt[:, 0, :]
        if fb_static is True:
            return fast(phases, dt_rows, mix, *e)
        if fb_static is None:
            return jax.lax.cond(jnp.all(fb == 0.0),
                                lambda: fast(phases, dt_rows, mix, *e),
                                seq)
    return seq()


def fm_chain3_scan(phases, prevs, dt, lvl, fb, mix, env3, env2, env1,
                   fb_static=None):
    """One block of the fused 3-operator FM voice chain, all voices.

    Args: phases/prevs ``[3, V]`` (op3, op2, op1 order); dt ``[3, B, V]``
    per-sample phase increments (pitch changes mid-block at note-on) or
    ``[3, 1, V]`` block-constant; lvl/fb ``[3, V]`` block-constant per-op
    params; mix ``[V]`` (route, clamped); env* ``[B, V]`` envelope
    streams.  Returns (y ``[B, V]``, phases', prevs').

    Levels are folded into the envelope streams here (one [B, V]
    multiply each, outside the sequential scan); ``tick`` uses the same
    ``sin·(env·lvl)`` association so parity stays bit-exact.

    Blocks with constant pitch and every feedback at 0 take the
    zero-feedback path.  ``fb_static`` resolves that branch at TRACE time
    when the feedback params are trace-time literals: True compiles ONLY
    the zero-feedback path, False only the sequential scan, None emits the
    runtime ``lax.cond``.
    """
    return _chain3(fm_chain_step, _fm_chain3_fast, phases, prevs, dt, lvl,
                   fb, mix, env3, env2, env1, fb_static)


def pivot_chain3_scan(phases, prevs, dt, lvl, fb, mix, env3, env2, env1,
                      fb_static=None):
    """One block of the fused pivot operator chain, all voices.

    Args as :func:`fm_chain3_scan`; ``prevs`` carries the RAW sine
    history (the pivot feedback path).  Returns (y ``[B, V]`` — the vca1
    output, pre-filter; phases'; prevs')."""
    return _chain3(pivot_chain_step, _pivot_chain3_fast, phases, prevs, dt,
                   lvl, fb, mix, env3, env2, env1, fb_static)
