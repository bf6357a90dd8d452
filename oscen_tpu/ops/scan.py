"""Parallel-in-time primitives for per-sample recurrences.

The reference evaluates every IIR/one-pole/phase recurrence one sample at a
time (SignalProcessor::process, graph/traits.rs:27-52).  Where the time axis
should be parallel, linear recurrences are reformulated as *associative
scans over affine maps* and phase accumulation as prefix sums (SURVEY §5.7).

``affine_scan`` solves ``z[t] = A[t] @ z[t-1] + b[t]`` for all t in
O(log B) depth using ``jax.lax.associative_scan`` over the monoid
``(A2, b2) ∘ (A1, b1) = (A2@A1, A2@b1 + b2)``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def affine_scan(A, b, z0):
    """Solve the time-varying affine recurrence.

    Args:
      A: ``[B, S, S]`` (or ``[B]`` for scalar S=1 passed as ``[B,1,1]``)
         per-step transition matrices.
      b: ``[B, S]`` per-step offsets.
      z0: ``[S]`` initial state (state *before* step 0).

    Returns:
      z: ``[B, S]`` where ``z[t]`` is the state *after* step t.
    """
    # DSP state recurrences need true f32 accumulation: a reduced-precision
    # default (TF32 on a GPU) is audible — force HIGHEST.
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    def combine(left, right):
        A1, b1 = left
        A2, b2 = right
        return (mm(A2, A1), jnp.squeeze(mm(A2, b1[..., None]), -1) + b2)

    A_acc, b_acc = jax.lax.associative_scan(combine, (A, b), axis=0)
    # z[t] = A_acc[t] @ z0 + b_acc[t]
    z = jnp.squeeze(mm(A_acc, z0[..., None]), -1) + b_acc
    return z


def affine_scan_2x2(a00, a01, a10, a11, b0, b1, z0, z1):
    """Specialized 2-state affine scan with the 2x2 composition unrolled
    into elementwise ops (a batched [B,...,2,2] matmul lowers to a tiny
    dot_general; this form stays fully elementwise).

    Solves z[t] = A[t] z[t-1] + b[t]; returns (z0s, z1s) with the state
    *after* each step.  All args broadcast over trailing dims.
    """
    ones = jnp.ones_like(b0)
    A = (a00 * ones, a01 * ones, a10 * ones, a11 * ones)

    def combine(left, right):
        l00, l01, l10, l11, lb0, lb1 = left
        r00, r01, r10, r11, rb0, rb1 = right
        # A = R @ L ; b = R @ lb + rb
        return (r00 * l00 + r01 * l10,
                r00 * l01 + r01 * l11,
                r10 * l00 + r11 * l10,
                r10 * l01 + r11 * l11,
                r00 * lb0 + r01 * lb1 + rb0,
                r10 * lb0 + r11 * lb1 + rb1)

    c00, c01, c10, c11, cb0, cb1 = jax.lax.associative_scan(
        combine, (*A, b0, b1), axis=0)
    return (c00 * z0 + c01 * z1 + cb0,
            c10 * z0 + c11 * z1 + cb1)


def affine_scan_scalar(a, b, z0):
    """Scalar special case: ``z[t] = a[t] * z[t-1] + b[t]``.

    Args:
      a, b: ``[B, ...]`` (broadcastable trailing dims, e.g. channels).
      z0: ``[...]`` initial state.
    Returns ``z: [B, ...]`` (state after each step).
    """
    def combine(left, right):
        a1, b1 = left
        a2, b2 = right
        return (a2 * a1, a2 * b1 + b2)

    a_acc, b_acc = jax.lax.associative_scan(combine, (a, b), axis=0)
    return a_acc * z0 + b_acc


def phase_step(p, d):
    """One tick of the wrapped phase accumulator: emit the phase, then
    ``p += dt; p -= floor(p)`` (``rem_euclid(1.0)``)."""
    out = p
    p = p + d
    p = p - jnp.floor(p)
    return p, out


def exact_wrapped_phase(phase0, dt):
    """Sequential-exact wrapped phase accumulation.

    Op-order parity with the per-sample tick (``p += dt; p -= floor(p)``),
    which makes block-mode output *bit-identical across block sizes*: the
    carry after N samples is the same f32 no matter where block boundaries
    fall.  The prefix-sum form (:func:`wrapped_phase_cumsum`) reassociates
    the adds and drifts ~1e-3 RMS per rendered second.

    Runs as :func:`~oscen_tpu.ops.pallas.recurrence.lane_scan` over the
    trailing dims as lanes (the Triton kernel on a GPU, ``lax.scan`` on
    the CPU).

    Returns ``(before [B, ...], carry [...])`` where ``before[t]`` is the
    wrapped phase *prior* to adding ``dt[t]``.
    """
    from .pallas.recurrence import lane_scan
    B, trailing = dt.shape[0], dt.shape[1:]
    p0 = jnp.broadcast_to(jnp.asarray(phase0, jnp.float32), trailing)
    carry, before = lane_scan(phase_step, jnp.reshape(p0, (-1,)),
                              jnp.reshape(dt, (B, -1)))
    return jnp.reshape(before, dt.shape), jnp.reshape(carry, trailing)


def wrapped_phase_cumsum(phase0, dt):
    """Phase accumulation ``phase[t] = wrap(phase0 + sum_{i<=t} dt[i])``.

    The reference wraps per sample (``phase.rem_euclid(1.0)``,
    oscillators/mod.rs:171-174); wrapping a prefix sum is mathematically
    identical and fully parallel.  Returns (phase_before_step ``[B, ...]``,
    final_carry) where ``phase_before_step[t]`` is the phase value *prior*
    to adding ``dt[t]`` — the value the reference uses to synthesize the
    output at sample t.
    """
    csum = jnp.cumsum(dt, axis=0)
    before = jnp.concatenate(
        [jnp.zeros_like(csum[:1]), csum[:-1]], axis=0) + phase0
    before = before - jnp.floor(before)
    carry = phase0 + csum[-1]
    carry = carry - jnp.floor(carry)
    return before, carry
