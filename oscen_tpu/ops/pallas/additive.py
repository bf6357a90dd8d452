"""Fused Triton kernel for the electric-piano additive voice.

Runs the reference voice algorithm (AmplitudeSource → OscillatorBank,
electric_piano_voice.rs) for all voices and all 32 harmonics inside one
kernel, so no ``[V, B, H]`` plane ever reaches device memory; with the
fan-in mixdown fused, only per-program partial sums of the ``[B]`` mix
leave it.

Steady-state blocks only (no gate events, constant frequency within the
block): event blocks take the segmented closed forms of the two nodes.

The grid covers voice tiles × time chunks, and no state passes between
programs.  Each chunk starts from its entry state in closed form, built by
XLA before the launch:

- **rotation**: the oscillator at chunk start ``t0`` is ``z0·m^t0``.
  Inside a chunk the kernel walks subgroups of ``SUB`` samples; sample
  ``j`` of a subgroup is ``Im(z·m^(j+1))`` from a ``[SUB, H, TV]`` tile of
  powers built once per program, and the subgroup carry advances by
  ``m^SUB``.
- **envelope**: the per-tick blend telescopes to ``amp_k = T + E·c_k``,
  where ``(T, E)`` change only at the cycle wrap (``E ← T(1-m)``,
  ``T ← T·m``) and ``c_k`` is a per-voice blend coefficient.  The
  ``[B, V]`` rows of ``c_k`` and of the running wrap count are computed by
  XLA; a subgroup (``SUB ≤ 64`` < the 65-tick cycle) sees at most one wrap.

Numerics: the closed forms reassociate the reference's per-sample f32
rotation and blend, so the output deviates from the per-sample path by
at most about 5e-4 absolute at unit-scale output (the reference's own f32
rotation drifts comparably against exact math).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .recurrence import next_pow2
from .util import pick_unroll

INTERP = 64
CYCLE = INTERP + 1

SUB = 32     # samples per subgroup (one wrap at most: SUB < CYCLE)
TV = 4       # voices per program
CHUNK = 256  # samples per program
NUM_WARPS = 4

# The compiled kernel costs about 50 µs per block whatever the voice
# count, while XLA's closed form grows with voices × samples; on an H100
# the two meet near 2^16 voice-samples per block (64 voices at B=1024,
# 16 at B=4096).
MIN_VOICE_SAMPLES = 1 << 16

# P[j] = prod_{i=1..j} (1 - i/64): the blend coefficient j ticks into a
# cycle (P[64] = P[65] = 0: the last interpolation tick and the settle
# tick both land on the target)
_P_EXT = np.cumprod(np.concatenate(
    [[1.0], 1.0 - np.arange(1, CYCLE + 1) / INTERP])).astype(np.float32)


def supported(block_len: int) -> bool:
    """The kernel needs whole subgroups of at least 8 samples."""
    return block_len % 8 == 0


def kernel_pays(num_voices: int, block_len: int) -> bool:
    """Whether the compiled kernel beats XLA's closed form at this size."""
    return num_voices * block_len >= MIN_VOICE_SAMPLES


def _int_pow(m, n, nbits: int):
    """``m ** n`` elementwise for an int exponent array (square and
    multiply over ``nbits`` bits)."""
    acc = jnp.ones_like(m)
    p = m
    for b in range(nbits):
        acc = jnp.where(((n >> b) & 1) == 1, acc * p, acc)
        p = p * p
    return acc


def _envelope_rows(step, block_len):
    """Per-tick, per-voice rows of the envelope closed form.

    Returns ``(c [B, V], n [B, V], kw [V])``: the blend coefficient of
    tick k, the number of cycle wraps through tick k (float), and the
    first wrap tick."""
    s0 = step.astype(jnp.int32)
    kw = jnp.where(s0 == 0, 0, CYCLE - s0)
    k = jnp.arange(block_len, dtype=jnp.int32)[:, None]
    sk = jnp.mod(s0 + k, CYCLE)
    # before the first wrap the blend continues from the entry state:
    # q_k = prod_{i=s0+1..s0+k+1} (1 - i/64)
    nq = min(block_len, CYCLE)
    kq = jnp.arange(nq, dtype=jnp.float32)[:, None]
    f = 1.0 - (s0.astype(jnp.float32) + kq + 1.0) / INTERP
    q = jnp.cumprod(jnp.where(kq < kw, f, 0.0), axis=0)
    q = jnp.pad(q, ((0, block_len - nq), (0, 0)))
    c = jnp.where(k < kw, q, jnp.take(jnp.asarray(_P_EXT), sk + 1))
    n = jnp.where(k >= kw, (k - kw) // CYCLE + 1, 0)
    return c, n.astype(jnp.float32), kw


def _entry_states(z_re, z_im, m_re, m_im, tgt0, d0, mult, kw, t0s, chunk):
    """Closed-form state at each chunk start ``t0`` (all static,
    ``t0s[i] = i*chunk``): oscillator ``z0·m^t0`` and envelope ``(T, E)``
    after the wraps before ``t0``.  Returns ``[len(t0s), H, V]`` planes
    and the wrap counts ``[len(t0s), V]``."""
    # m^chunk by squaring (chunk is a power of two)
    pr, pi = m_re, m_im
    for _ in range(int(math.log2(chunk))):
        pr, pi = pr * pr - pi * pi, 2.0 * pr * pi
    zr, zi = [z_re], [z_im]
    for _ in t0s[1:]:
        r, i = zr[-1], zi[-1]
        zr.append(r * pr - i * pi)
        zi.append(r * pi + i * pr)
    t0 = jnp.asarray(t0s, jnp.int32)[:, None]
    nb = jnp.where(t0 > kw, (t0 - 1 - kw) // CYCLE + 1, 0)    # [C, V]
    nbits = max(1, int(t0s[-1] // CYCLE + 2).bit_length())
    prev = tgt0 * _int_pow(mult[None], jnp.maximum(nb - 1, 0)[:, None],
                           nbits)
    t_n = prev * mult
    wrapped = (nb > 0)[:, None]
    T = jnp.where(wrapped, t_n, tgt0)
    E = jnp.where(wrapped, prev - t_n, d0)
    return jnp.stack(zr), jnp.stack(zi), T, E, nb.astype(jnp.float32)


def _kernel(sub, with_mix, zr_ref, zi_ref, t_ref, e_ref, nb_ref, mr_ref,
            mi_ref, mult_ref, c_ref, n_ref, y_ref):
    mult = mult_ref[...]            # [H, TV]
    plane3 = (1,) + mult.shape
    mr = jnp.reshape(mr_ref[...], plane3)   # [1, H, TV]
    mi = jnp.reshape(mi_ref[...], plane3)
    L = c_ref.shape[0]

    # m^(j+1), j < sub: a [sub, H, TV] tile of powers (gain 3 folded in)
    e = jnp.reshape(jnp.arange(sub, dtype=jnp.int32) + 1, (sub, 1, 1))
    ar = jnp.ones((sub,) + mult.shape, jnp.float32)
    ai = jnp.zeros((sub,) + mult.shape, jnp.float32)
    pr, pi = mr, mi
    for b in range(int(math.log2(sub)) + 1):
        bit = ((e >> b) & 1) == 1
        ar, ai = (jnp.where(bit, ar * pr - ai * pi, ar),
                  jnp.where(bit, ar * pi + ai * pr, ai))
        if b < int(math.log2(sub)):
            pr, pi = pr * pr - pi * pi, 2.0 * pr * pi
    msr = jnp.reshape(pr, mult.shape)      # m^sub
    msi = jnp.reshape(pi, mult.shape)
    mjr3 = ar * 3.0
    mji3 = ai * 3.0

    def subgroup(g, carry):
        zr, zi, T, E, ncur = carry
        rows = pl.ds(g * sub, sub)
        tv = ncur.shape[0]
        crow = jnp.reshape(c_ref[rows, :], (sub, 1, tv))
        after = jnp.reshape(n_ref[rows, :], (sub, 1, tv)) > jnp.reshape(
            ncur, (1, 1, tv))
        T2 = T * mult
        E2 = T - T2
        p3 = lambda x: jnp.reshape(x, plane3)
        amp = jnp.where(after, p3(T2) + p3(E2) * crow,
                        p3(T) + p3(E) * crow)
        im = p3(zr) * mji3 + p3(zi) * mjr3
        yv = jnp.sum(im * amp, axis=1)          # [sub, TV]
        if with_mix:
            y_ref[rows] = jnp.sum(yv, axis=1)
        else:
            y_ref[rows, :] = yv
        nlast = n_ref[g * sub + sub - 1, :]      # [TV]
        w = jnp.reshape(nlast > ncur, (1, tv))
        return (zr * msr - zi * msi, zr * msi + zi * msr,
                jnp.where(w, T2, T), jnp.where(w, E2, E), nlast)

    jax.lax.fori_loop(0, L // sub, subgroup,
                      (zr_ref[...], zi_ref[...], t_ref[...], e_ref[...],
                       nb_ref[...]))


@functools.partial(jax.jit, static_argnames=("block_len", "interpret",
                                             "with_mix"))
def additive_voice_block(osc_re, osc_im, mul_re, mul_im, cur, tgt, mult,
                         step, block_len: int, interpret: bool = False,
                         with_mix: bool = False):
    """One steady-state block of the fused additive voice.

    Args (all ``[H, V]`` except ``step`` ``[V]``): oscillator complex
    state and rotation multipliers, envelope current/target/multiplier
    planes, per-voice interpolation step counter (0..64).
    Returns (y ``[B, V]``, new osc_re, osc_im, cur, tgt, step) — or, with
    ``with_mix``, y is the voice-summed mix ``[B]`` (the graph's FanIn
    edge fused into the kernel; per-program partial sums added by XLA).
    """
    if not supported(block_len):
        raise ValueError(f"block_len must be a multiple of 8 for the "
                         f"fused kernel (got {block_len})")
    H, V = osc_re.shape
    B = block_len
    sub = pick_unroll(B, SUB)
    chunk = pick_unroll(B, CHUNK)
    n_chunks = B // chunk
    tv = min(TV, next_pow2(V))
    Hp, Vp = next_pow2(H), -(-V // tv) * tv

    s0 = step.astype(jnp.int32)
    tgt0 = jnp.where(s0[None, :] == 0, cur, tgt)
    d0 = cur - tgt0
    c, n, kw = _envelope_rows(s0, B)
    t0s = tuple(range(0, B + 1, chunk))
    zr, zi, T, E, nb = _entry_states(osc_re, osc_im, mul_re, mul_im, tgt0,
                                     d0, mult, kw, t0s, chunk)

    def pad(x):  # zero voices / harmonics contribute nothing
        widths = [(0, 0)] * x.ndim
        widths[-1] = (0, Vp - V)
        if x.ndim >= 2 and x.shape[-2] == H and x is not c and x is not n:
            widths[-2] = (0, Hp - H)
        return jnp.pad(x, widths)

    grid = (Vp // tv, n_chunks)
    entry = pl.BlockSpec((None, Hp, tv), lambda v, k: (k, 0, v))
    plane = pl.BlockSpec((Hp, tv), lambda v, k: (0, v))
    rows = pl.BlockSpec((chunk, tv), lambda v, k: (k, v))
    if with_mix:
        y_shape = jax.ShapeDtypeStruct((grid[0], B), jnp.float32)
        y_spec = pl.BlockSpec((None, chunk), lambda v, k: (v, k))
    else:
        y_shape = jax.ShapeDtypeStruct((B, Vp), jnp.float32)
        y_spec = rows
    y = pl.pallas_call(
        functools.partial(_kernel, sub, with_mix),
        out_shape=y_shape,
        grid=grid,
        in_specs=[entry] * 4
        + [pl.BlockSpec((None, tv), lambda v, k: (k, v))]
        + [plane] * 3 + [rows] * 2,
        out_specs=y_spec,
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="additive_voice",
    )(pad(zr[:-1]), pad(zi[:-1]), pad(T[:-1]), pad(E[:-1]), pad(nb[:-1]),
      pad(mul_re), pad(mul_im), pad(mult), pad(c), pad(n))

    # state after the block: the closed form at t0 = B
    cur_o = T[-1] + E[-1] * c[-1][None, :]
    step_o = jnp.mod(s0 + B, CYCLE)
    y_out = jnp.sum(y, axis=0) if with_mix else y[:, :V]
    return y_out, zr[-1], zi[-1], cur_o, T[-1], step_o
