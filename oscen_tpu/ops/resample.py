"""Fixed-ratio resampler kernels for multirate (oversampled) regions.

Counterparts of the reference's kernel families
(/root/reference/oscen-lib/src/resample/): Latch (zero-order hold), Linear,
Sinc FIR (23-tap Kaiser halfband, polyphase, cascaded 2x stages) and IIR
halfband (two-branch 1st-order allpass cascade).  Same coefficients, same
latencies; the per-sample history loops become whole-block convolutions
(FIR) and sequential-exact lane scans (IIR allpass).

Every kernel is expressed as ``(init_state, process_block)``:
``process_block(state, x) -> (state, y)`` maps ``[B,...]`` to ``[B*N,...]``
(up) or ``[B*N,...]`` to ``[B,...]`` (down), carrying filter histories
across blocks.  All kernels operate on the leading time axis and broadcast
over trailing channel axes.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .pallas.recurrence import lane_scan


# --------------------------------------------------------------------- #
# coefficients (reference resample/coeffs.rs)
# --------------------------------------------------------------------- #
# Half of the non-zero taps of the 23-tap Kaiser (β≈8.6) halfband FIR;
# HALFBAND_23_HALF[k] is the tap at index 2k (k = 0..5).  Center tap
# (index 11) stored separately.  Stopband ≈ -90 dB above 0.55π.
HALFBAND_23_HALF = np.array([
    -3.8558514e-5, 1.2218465e-3, -7.2854808e-3,
    2.6409210e-2, -7.8128843e-2, 3.0782697e-1], np.float32)
HALFBAND_23_CENTER = np.float32(0.4999897)
HALFBAND_23_GROUP_DELAY = 11  # at the high (2x) rate

# IIR halfband: two-branch allpass cascade betas (reference coeffs.rs:48-49)
BRANCH_A_BETAS = (0.1355741, 0.6975849)
BRANCH_B_BETAS = (0.4253804, 0.9055601)
IIR_HALFBAND_GROUP_DELAY = 2

# full 23-tap halfband impulse response (for convolution forms)
_HB23 = np.zeros((23,), np.float32)
for _k, _tap in enumerate(HALFBAND_23_HALF):
    _HB23[2 * _k] = _tap
    _HB23[22 - 2 * _k] = _tap
_HB23[11] = HALFBAND_23_CENTER

DENORMAL_THRESHOLD = 1e-15


def _stages(n: int) -> int:
    if n not in (1, 2, 4, 8):
        raise ValueError("oversampling factor must be 1, 2, 4 or 8")
    return n.bit_length() - 1


def _causal_fir(x, hist, taps):
    """Causal FIR along axis 0 with carried history.

    ``hist``: [len(taps)-1, ...] previous inputs (most recent last).
    Returns (y [B,...], new_hist).

    Shifted-add form: t slice+FMA ops that XLA fuses into one pass.
    """
    t = len(taps)
    z = jnp.concatenate([hist, x], axis=0)
    y = jnp.zeros_like(x)
    for k in range(t):
        y = y + taps[k] * jax.lax.slice_in_dim(
            z, t - 1 - k, t - 1 - k + x.shape[0], axis=0)
    new_hist = z[-(t - 1):] if t > 1 else hist
    return y, new_hist


# --------------------------------------------------------------------- #
# Latch (reference resample/latch.rs) — zero-order hold; latency 0
# --------------------------------------------------------------------- #
class LatchUp:
    def __init__(self, n: int):
        self.n = n

    def init_state(self, like=None):
        return ()

    def process_block(self, state, x):
        return state, jnp.repeat(x, self.n, axis=0)

    def latency_samples(self) -> int:
        return 0


class LatchDown:
    def __init__(self, n: int):
        self.n = n

    def init_state(self, like=None):
        return ()

    def process_block(self, state, x):
        return state, x[::self.n]

    def latency_samples(self) -> int:
        return 0


# --------------------------------------------------------------------- #
# Linear (reference resample/linear.rs)
# --------------------------------------------------------------------- #
class LinearUp:
    """N-point linear interp vs the previous source sample; latency N."""

    def __init__(self, n: int):
        self.n = n

    def init_state(self, like=None):
        shape = jnp.shape(like)[1:] if like is not None else ()
        return {"prev": jnp.zeros(shape, jnp.float32)}

    def process_block(self, state, x):
        n = self.n
        prev = jnp.concatenate([state["prev"][None], x[:-1]], axis=0)
        frac = (jnp.arange(n, dtype=jnp.float32) / n)
        frac = frac.reshape((1, n) + (1,) * (x.ndim - 1))
        seg = prev[:, None] + (x - prev)[:, None] * frac
        y = seg.reshape((x.shape[0] * n,) + x.shape[1:])
        return {"prev": x[-1]}, y

    def latency_samples(self) -> int:
        return self.n


class LinearDown:
    """N-tap box average; latency (N-1)/2 source samples."""

    def __init__(self, n: int):
        self.n = n

    def init_state(self, like=None):
        return ()

    def process_block(self, state, x):
        n = self.n
        grp = x.reshape((x.shape[0] // n, n) + x.shape[1:])
        return state, jnp.mean(grp, axis=1)

    def latency_samples(self) -> int:
        return (self.n - 1) // 2


# --------------------------------------------------------------------- #
# Sinc FIR halfband (reference resample/sinc_fir.rs)
# --------------------------------------------------------------------- #
class _Halfband2xUp:
    """One polyphase 2x up stage: even branch = 12-tap FIR over the
    low-rate stream (x2 gain), odd branch = delayed center tap
    (reference sinc_fir.rs:33-82)."""

    EVEN_TAPS = np.concatenate([HALFBAND_23_HALF,
                                HALFBAND_23_HALF[::-1]]) * 2.0
    ODD_GAIN = float(2.0 * HALFBAND_23_CENTER)
    ODD_DELAY = 5

    def init_state(self, like=None):
        shape = jnp.shape(like)[1:] if like is not None else ()
        return {"hist": jnp.zeros((11,) + shape, jnp.float32),
                "odd_hist": jnp.zeros((self.ODD_DELAY,) + shape,
                                      jnp.float32)}

    def process_block(self, state, x):
        even, hist = _causal_fir(x, state["hist"], self.EVEN_TAPS)
        zo = jnp.concatenate([state["odd_hist"], x], axis=0)
        odd = zo[:x.shape[0]] * self.ODD_GAIN
        odd_hist = zo[-self.ODD_DELAY:]
        y = jnp.stack([even, odd], axis=1).reshape(
            (2 * x.shape[0],) + x.shape[1:])
        return {"hist": hist, "odd_hist": odd_hist}, y


class _Halfband2xDown:
    """One 2x down stage: 23-tap FIR at the high rate sampled at even
    indices (reference sinc_fir.rs:84-144).

    Computed polyphase at the LOW rate: only even output samples are
    kept, and a halfband's odd taps are zero except the center, so
    ``y[n] = Σ_j h[2j]·x_even[n-j] + h[11]·x_odd[n-6]`` — 13 tap-MACs
    over [B]-length streams instead of 23 over [2B] (3.5× less work).
    The accumulation order interleaves the center tap between j=5 and
    j=6 exactly where tap index 11 sits in the flat 23-tap loop, so the
    result is bit-identical to the direct high-rate form."""

    EVEN_TAPS = np.concatenate([HALFBAND_23_HALF, HALFBAND_23_HALF[::-1]])
    CENTER = float(HALFBAND_23_CENTER)
    ODD_DELAY = 6

    def init_state(self, like=None):
        shape = jnp.shape(like)[1:] if like is not None else ()
        return {"hist_e": jnp.zeros((11,) + shape, jnp.float32),
                "hist_o": jnp.zeros((self.ODD_DELAY,) + shape,
                                    jnp.float32)}

    def process_block(self, state, x):
        b = x.shape[0] // 2
        pair = x.reshape((b, 2) + x.shape[1:])
        e, o = pair[:, 0], pair[:, 1]
        ze = jnp.concatenate([state["hist_e"], e], axis=0)
        zo = jnp.concatenate([state["hist_o"], o], axis=0)
        taps = self.EVEN_TAPS
        y = jnp.zeros_like(e)
        for j in range(12):
            if j == 6:  # flat tap index 11 (the center) lands here
                y = y + self.CENTER * jax.lax.slice_in_dim(
                    zo, 0, b, axis=0)
            y = y + taps[j] * jax.lax.slice_in_dim(
                ze, 11 - j, 11 - j + b, axis=0)
        return {"hist_e": ze[-11:], "hist_o": zo[-self.ODD_DELAY:]}, y


class SincUpFir:
    """Cascaded halfband 2x up stages for N ∈ {1,2,4,8}
    (reference sinc_fir.rs:146-206), each stage an interleaved polyphase
    FIR over the whole block."""

    def __init__(self, n: int):
        self.n = n
        self.k = _stages(n)
        self.stages = [_Halfband2xUp() for _ in range(self.k)]

    def init_state(self, like=None):
        return tuple(s.init_state(like) for s in self.stages)

    def process_block(self, state, x):
        new = []
        for st, stage in zip(state, self.stages):
            st, x = stage.process_block(st, x)
            new.append(st)
        return tuple(new), x

    def latency_samples(self) -> int:
        k = len(self.stages)
        return 0 if k == 0 else HALFBAND_23_GROUP_DELAY * ((1 << k) - 1)


class SincDownFir:
    """Cascaded halfband 2x down stages (reference sinc_fir.rs:84-144),
    each computed polyphase at its low rate (see :class:`_Halfband2xDown`).

    Parity with the reference's per-sample loop is tolerance-level only:
    the reference accumulates the center tap first and symmetric pairs as
    ``(left+right)*tap`` — a different float op order."""

    def __init__(self, n: int):
        self.n = n
        self.k = _stages(n)
        self.stages = [_Halfband2xDown() for _ in range(self.k)]

    def init_state(self, like=None):
        return tuple(s.init_state(like) for s in self.stages)

    def process_block(self, state, x):
        new = []
        for st, stage in zip(state, self.stages):
            st, x = stage.process_block(st, x)
            new.append(st)
        return tuple(new), x

    def latency_samples(self) -> int:
        k = self.k
        return 0 if k == 0 else HALFBAND_23_GROUP_DELAY * ((1 << k) - 1)


# --------------------------------------------------------------------- #
# IIR halfband (reference resample/halfband_iir.rs)
# --------------------------------------------------------------------- #
def allpass_cascade_step(betas, carry, x):
    """One sample through a cascade of first-order allpasses
    ``y = a (x - y_prev) + x_prev`` with the reference's exact op order
    (halfband_iir.rs:24-63); ``carry`` is the per-stage
    ``(x_prev, y_prev)`` histories."""
    xps, yps = carry
    nxp, nyp = [], []
    cur = x
    for a, xp, yp in zip(betas, xps, yps):
        y = a * (cur - yp) + xp
        nxp.append(cur)
        nyp.append(y)
        cur = y
    return (tuple(nxp), tuple(nyp)), cur


class _IirHalfband2x:
    """Two-branch allpass polyphase halfband (reference :65-145)."""

    def init_state(self, like=None):
        shape = jnp.shape(like)[1:] if like is not None else ()
        z = jnp.zeros(shape, jnp.float32)
        return {
            "a_x": (z, z), "a_y": (z, z),
            "b_x": (z, z), "b_y": (z, z),
            "prev_odd": z,
        }

    def _branch(self, betas, xs, x_prevs, y_prevs):
        # sequential-exact (exact op order, so oversampled regions stay
        # block-size invariant; an associative-scan form reassociates and
        # makes output depend on where block boundaries fall)
        (new_xp, new_yp), y = lane_scan(
            functools.partial(allpass_cascade_step, tuple(betas)),
            (tuple(x_prevs), tuple(y_prevs)), xs)
        return y, new_xp, new_yp

    def up(self, state, x):
        ya, axp, ayp = self._branch(BRANCH_A_BETAS, x, state["a_x"],
                                    state["a_y"])
        yb, bxp, byp = self._branch(BRANCH_B_BETAS, x, state["b_x"],
                                    state["b_y"])
        y = jnp.stack([ya, yb], axis=1).reshape(
            (2 * x.shape[0],) + x.shape[1:])
        return {**state, "a_x": axp, "a_y": ayp, "b_x": bxp,
                "b_y": byp}, y

    def down(self, state, x):
        even = x[::2]
        odd = x[1::2]
        odd_delayed = jnp.concatenate([state["prev_odd"][None], odd[:-1]],
                                      axis=0)
        ya, axp, ayp = self._branch(BRANCH_A_BETAS, even, state["a_x"],
                                    state["a_y"])
        yb, bxp, byp = self._branch(BRANCH_B_BETAS, odd_delayed,
                                    state["b_x"], state["b_y"])
        y = (ya + yb) * 0.5
        return {"a_x": axp, "a_y": ayp, "b_x": bxp, "b_y": byp,
                "prev_odd": odd[-1]}, y


class IirHalfbandUp:
    def __init__(self, n: int):
        self.n = n
        self.stages = [_IirHalfband2x() for _ in range(_stages(n))]

    def init_state(self, like=None):
        return tuple(s.init_state(like) for s in self.stages)

    def process_block(self, state, x):
        new = []
        for st, stage in zip(state, self.stages):
            st, x = stage.up(st, x)
            new.append(st)
        return tuple(new), x

    def latency_samples(self) -> int:
        k = len(self.stages)
        return 0 if k == 0 else IIR_HALFBAND_GROUP_DELAY * ((1 << k) - 1)


class IirHalfbandDown:
    def __init__(self, n: int):
        self.n = n
        self.stages = [_IirHalfband2x() for _ in range(_stages(n))]

    def init_state(self, like=None):
        return tuple(s.init_state(like) for s in self.stages)

    def process_block(self, state, x):
        new = []
        for st, stage in zip(state, self.stages):
            st, x = stage.down(st, x)
            new.append(st)
        return tuple(new), x

    def latency_samples(self) -> int:
        k = len(self.stages)
        return 0 if k == 0 else IIR_HALFBAND_GROUP_DELAY * ((1 << k) - 1)


# --------------------------------------------------------------------- #
def make_upsampler(policy: str, n: int):
    """Kernel factory: policy -> upsampler (reference dispatch tables,
    dispatch/stream.rs:95-104; default stream policy is sinc FIR,
    default value policy is latch)."""
    return {"latch": LatchUp, "linear": LinearUp, "sinc": SincUpFir,
            "sinc_iir": IirHalfbandUp}[policy](n)


def make_downsampler(policy: str, n: int):
    return {"latch": LatchDown, "linear": LinearDown, "sinc": SincDownFir,
            "sinc_iir": IirHalfbandDown}[policy](n)
