"""One Triton kernel for every per-sample recurrence, lanes in parallel.

Phase accumulators, the TPT / biquad / LP18 filters, the allpass
cascades of the IIR halfband resamplers and the FM operators all carry a
small state from one sample to the next.  Their block paths keep the
reference's exact per-sample op order (bit-parity with ``tick``), so the
time axis stays sequential and only the lanes (voices, channels) are
parallel.

:func:`lane_scan` has the contract of ``jax.lax.scan`` restricted to
lanes: ``step(carry, x) -> (carry, y)`` is elementwise over a lane axis
(in the kernel every leaf is a ``[T]`` row of lanes).  On a GPU it runs as one Triton
kernel: one program per power-of-two lane tile, a ``fori_loop`` over
time, the input rows loaded and the output rows stored per step, and the
carry kept in registers.  Without a kernel route (the CPU) it is the
same ``step`` under ``lax.scan``; tests run the kernel in interpret mode.
Each family therefore keeps its op order in one source: its step
function.

Under ``vmap`` the batch axis folds into the lanes, so a vmapped scan is
still one launch.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .util import pallas_mode, pick_unroll

__all__ = ["lane_scan", "next_pow2"]

# Lanes per program.  The loop over time is the critical path, so a
# narrow tile (one warp) spreads the lanes over as many SMs as possible.
MAX_TILE = 32
MAX_UNROLL = 16


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _kernel(step, carry_def, x_def, const, B, U, n_c, n_x, *refs):
    c_in = refs[:n_c]
    x_in = refs[n_c:n_c + n_x]
    n_y = (len(refs) - 2 * n_c - n_x)
    y_out = refs[n_c + n_x:n_c + n_x + n_y]
    c_out = refs[n_c + n_x + n_y:]
    rows = {i: x_in[i][0, :] for i in range(n_x) if const[i]}
    seq = [i for i in range(n_x) if not const[i]]
    n_body = B // U

    def load(i):
        # the U input rows of loop body i, all issued back to back
        return [[x_in[k][i * U + j, :] for k in seq] for j in range(U)]

    def body(i, state):
        carry, cur = state
        # prefetch the next body's rows so their latency hides behind
        # this body's dependent chain (the last body reloads itself)
        nxt = load(jnp.minimum(i + 1, n_body - 1))
        outs = []
        for j in range(U):
            it = iter(cur[j])
            xs = [rows[k] if const[k] else next(it) for k in range(n_x)]
            carry, ys = step(jax.tree.unflatten(carry_def, carry),
                             jax.tree.unflatten(x_def, xs))
            carry = jax.tree.leaves(carry)
            outs.append(jax.tree.leaves(ys))
        for j, ys in enumerate(outs):
            for ref, y in zip(y_out, ys):
                ref[i * U + j, :] = y
        return carry, nxt

    carry, _ = jax.lax.fori_loop(0, n_body, body,
                                 ([r[...] for r in c_in], load(0)))
    for ref, c in zip(c_out, carry):
        ref[...] = c


def _pallas_scan(step, init, xs, length, interpret, unroll=None):
    c_leaves, carry_def = jax.tree.flatten(init)
    x_leaves, x_def = jax.tree.flatten(xs)
    lanes = jnp.shape(c_leaves[0])
    V = math.prod(lanes)
    B = _length(x_leaves, length)
    const = tuple(x.shape[0] < B for x in x_leaves)
    tile = min(MAX_TILE, next_pow2(V))
    Vp = -(-V // tile) * tile

    def pad(x):
        return jnp.pad(x.astype(jnp.float32),
                       [(0, 0)] * (x.ndim - 1) + [(0, Vp - V)])

    carry_in = [pad(jnp.reshape(c, (V,))) for c in c_leaves]
    x_in = [pad(jnp.reshape(jnp.broadcast_to(
        jnp.reshape(x, x.shape + (1,) * (1 + len(lanes) - x.ndim)),
        (x.shape[0],) + lanes), (x.shape[0], V))) for x in x_leaves]

    # output structure: trace the step once on row shapes
    row = jax.ShapeDtypeStruct((tile,), jnp.float32)
    _, y_shapes = jax.eval_shape(
        step, jax.tree.unflatten(carry_def, [row] * len(c_leaves)),
        jax.tree.unflatten(x_def, [row] * len(x_leaves)))
    y_leaves, y_def = jax.tree.flatten(y_shapes)

    if unroll is None:
        # interpret mode runs one step per loop body: XLA's CPU backend
        # contracts FMAs differently inside a multi-step body, and the
        # interpret route exists to match lax.scan bit for bit
        unroll = 1 if interpret else pick_unroll(B, MAX_UNROLL)
    c_spec = pl.BlockSpec((tile,), lambda i: (i,))
    x_specs = [pl.BlockSpec((x.shape[0], tile), lambda i: (0, i))
               for x in x_in]
    y_spec = pl.BlockSpec((B, tile), lambda i: (0, i))
    outs = pl.pallas_call(
        functools.partial(_kernel, step, carry_def, x_def, const, B,
                          unroll, len(c_leaves), len(x_leaves)),
        out_shape=[jax.ShapeDtypeStruct((B, Vp), jnp.float32)] * len(y_leaves)
        + [jax.ShapeDtypeStruct((Vp,), jnp.float32)] * len(c_leaves),
        grid=(Vp // tile,),
        in_specs=[c_spec] * len(c_leaves) + x_specs,
        out_specs=[y_spec] * len(y_leaves) + [c_spec] * len(c_leaves),
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="lane_scan",
    )(*carry_in, *x_in)
    ys = [jnp.reshape(y[:, :V], (B,) + lanes) for y in outs[:len(y_leaves)]]
    carry = [jnp.reshape(c[:V], lanes) for c in outs[len(y_leaves):]]
    return (jax.tree.unflatten(carry_def, carry),
            jax.tree.unflatten(y_def, ys))


def _length(x_leaves, length):
    return length if length is not None else max(
        x.shape[0] for x in x_leaves)


def _plain_scan(step, init, xs, length=None):
    x_leaves, x_def = jax.tree.flatten(xs)
    B = _length(x_leaves, length)
    const = [x.shape[0] < B for x in x_leaves]
    rows = [x[0] for x, c in zip(x_leaves, const) if c]
    seqs = [x for x, c in zip(x_leaves, const) if not c]

    def body(carry, seq_t):
        r, s = iter(rows), iter(seq_t)
        xt = [next(r) if c else next(s) for c in const]
        return step(carry, jax.tree.unflatten(x_def, xt))

    return jax.lax.scan(body, init, seqs, length=B)


def lane_scan(step, init, xs, length=None):
    """``jax.lax.scan(step, init, xs)`` for lane-parallel recurrences.

    Args:
      step: ``(carry, x) -> (carry, y)``, elementwise over lanes (lanes
        never interact).  It must close over no arrays: in the kernel
        its leaves are ``[T]`` rows of one lane tile.
      init: pytree of float32 carries, all of one lane shape ``S``.
      xs: pytree of per-sample inputs ``[B, ...]`` whose trailing dims
        broadcast to ``S``; a leaf with a leading 1 (and ``B > 1``) is
        block-constant: one row for every step.
      length: the number of steps ``B``; by default the longest leading
        dim of ``xs``.

    Returns ``(carry, ys)`` as ``lax.scan`` does (``ys`` leaves
    ``[B, *S]``).  On a GPU this is the compiled Triton kernel; on the
    CPU it is ``lax.scan`` unless ``OSCEN_PALLAS_INTERPRET=1`` asks for
    the kernel in interpret mode.
    """
    use, interpret = pallas_mode()
    if not use:
        return _plain_scan(step, init, xs, length)
    length = _length(jax.tree.leaves(xs), length)
    return _batched_pallas_scan(step, length, interpret)(init, xs)


def _batched_pallas_scan(step, length, interpret):
    @jax.custom_batching.custom_vmap
    def run(init, xs):
        return _pallas_scan(step, init, xs, length, interpret)

    @run.def_vmap
    def _rule(axis_size, in_batched, init, xs):
        # fold the batch axis into the lanes: lane shape S -> (N, *S)
        init_b, xs_b = in_batched

        def bcast(v, b):
            return v if b else jnp.broadcast_to(v, (axis_size,) + v.shape)

        init_f = jax.tree.map(bcast, init, init_b)
        lanes = jnp.shape(jax.tree.leaves(init_f)[0])[1:]

        def seq_in(x, b):
            x = jnp.moveaxis(bcast(x, b), 0, 1)   # [L0, N, *rest]
            rest = x.shape[2:]
            return jnp.reshape(x, x.shape[:2] + (1,) * (len(lanes) - len(
                rest)) + rest)

        carry, ys = run(init_f, jax.tree.map(seq_in, xs, xs_b))
        ys = jax.tree.map(lambda y: jnp.moveaxis(y, 1, 0), ys)
        out_b = jax.tree.map(lambda _: True, (carry, ys))
        return (carry, ys), out_b

    return run
