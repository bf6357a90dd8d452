"""Impulse-response convolution — frequency-domain delay line.

The reference achieves zero-latency convolution with a 3-tier Gardner
decomposition (direct head + 32-sample FFT stage + 512-sample FFT stage,
/root/reference/oscen-lib/src/convolution/mod.rs) because it must stream
*per sample*: each FFT stage adds its block size of latency, so the head
must be covered in the time domain.

Here the engine consumes whole blocks, so the tiering is unnecessary:
a **uniform-partition frequency-domain delay line at the graph block size**
applies partition 0 (lags ``[0, B)``) to the *current* input block —
sample-exact full convolution with zero latency (the same invariant the
Gardner stack sums to, convolution/mod.rs:10-17), as batched rFFT
multiply-accumulates.

IR capacity is fixed at construction (shorter IRs zero-pad), so hot-swaps
never change shapes — the "no retrace in the render loop" analogue of the
reference's allocation-free swap path.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BlockConvolver", "direct_conv_block"]


def direct_conv_block(x, hist, taps):
    """Brute-force time-domain FIR over a block with carried history
    (the reference DirectConvolver, convolution/mod.rs:47-83).
    ``hist``: [T-1, ...]; returns (y, new_hist)."""
    T = taps.shape[0]
    z = jnp.concatenate([hist, x], axis=0)
    y = jnp.zeros_like(x)
    for k in range(T):
        y = y + taps[k] * jax.lax.slice_in_dim(
            z, T - 1 - k, T - 1 - k + x.shape[0], axis=0)
    return y, z[-(T - 1):] if T > 1 else hist


class BlockConvolver:
    """Uniform-partition FDL convolver for blocks of ``block_size``.

    ``partitions`` spectra cover an IR of up to ``partitions*block_size``
    taps.  Per block: one rFFT of the sliding 2B window, a batched
    spectral MAC over all partitions, one irFFT — alias-free second half
    is the output (overlap-save).
    """

    def __init__(self, block_size: int, max_ir_len: int):
        if block_size <= 0:
            raise ValueError("block size must be positive")
        self.block = int(block_size)
        self.partitions = max(1, -(-int(max_ir_len) // self.block))
        self.fft_size = 2 * self.block
        self.nbins = self.block + 1

    # ------------------------------------------------------------------ #
    def ir_spectra(self, ir: np.ndarray) -> np.ndarray:
        """Precompute per-partition spectra ``[P, nbins, ...]`` complex64
        from a (possibly shorter) IR ``[len, ...]``; excess capacity
        zero-pads.  Trailing dims (channels) pass through."""
        ir = np.asarray(ir, np.float32)
        cap = self.partitions * self.block
        if len(ir) > cap:
            raise ValueError(
                f"IR length {len(ir)} exceeds capacity {cap}")
        trailing = ir.shape[1:]
        padded = np.zeros((cap,) + trailing, np.float32)
        padded[:len(ir)] = ir
        parts = padded.reshape((self.partitions, self.block) + trailing)
        buf = np.zeros((self.partitions, self.fft_size) + trailing,
                       np.float32)
        buf[:, :self.block] = parts
        return np.fft.rfft(buf, axis=1).astype(np.complex64)

    def init_state(self, trailing: Tuple[int, ...] = ()):
        return {
            "fdl": jnp.zeros((self.partitions, self.nbins) + trailing,
                             jnp.complex64),
            "prev": jnp.zeros((self.block,) + trailing, jnp.float32),
        }

    def process_block(self, state, h_spec, x
                      ) -> Tuple[dict, jnp.ndarray]:
        """One block: push x, return the exact convolution segment.

        ``h_spec``: [P, nbins, ...] complex; ``x``: [B, ...].  Returns
        (state', y [B, ...])."""
        state, fdl = self.spectral_mac(state, x)
        return state, self.apply(fdl, h_spec)

    def spectral_mac(self, state, x):
        """Push x and return the updated fdl + window spectrum, letting
        callers MAC several IR sets against one input (crossfade)."""
        window = jnp.concatenate([state["prev"], x], axis=0)
        X = jnp.fft.rfft(window, axis=0)
        fdl = jnp.concatenate([X[None], state["fdl"][:-1]], axis=0)
        return {"fdl": fdl, "prev": x}, fdl

    def apply(self, fdl, h_spec):
        Y = jnp.sum(h_spec * fdl, axis=0)
        return jnp.fft.irfft(Y, n=self.fft_size, axis=0)[self.block:] \
            .astype(jnp.float32)
