"""Kernel-route selection shared by the Pallas kernels."""

from __future__ import annotations

import os


def pallas_mode():
    """``(use_kernel, interpret)`` for the batched node fast paths.

    A GPU runs the compiled Triton kernels, always.  On the CPU backend
    ``OSCEN_PALLAS_INTERPRET=1`` runs the same kernels in interpret mode
    (a test route: it exercises the exact kernel code, including under a
    virtual-device mesh); without it the CPU takes the plain XLA path.
    """
    import jax
    backend = jax.default_backend()
    if backend == "gpu":
        return True, False
    if backend == "cpu" and os.environ.get("OSCEN_PALLAS_INTERPRET") == "1":
        return True, True
    return False, False


def pick_unroll(n: int, max_u: int) -> int:
    """Largest power of two <= ``max_u`` dividing ``n`` (the number of
    time steps a kernel's loop body runs back to back)."""
    u = 1
    while u * 2 <= max_u and n % (u * 2) == 0:
        u *= 2
    return u
