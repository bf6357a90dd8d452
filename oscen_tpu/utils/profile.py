"""Profiling utilities.

The reference's tracing story is criterion benches + flamegraphs (SURVEY
§5.1); the equivalents here: a real-time-factor meter over the fused
steady-state render, and a ``jax.profiler`` trace context for feeding the
TensorBoard/XProf toolchain.
"""

from __future__ import annotations

import contextlib
import time
import jax


def measure_rtf(compiled, n_blocks: int = 2048, trials: int = 5) -> dict:
    """Real-time factor of the fused steady-state render.

    Times a long and a short on-device span via ``steady_checksum`` (all
    compute forced, 4-byte fetch) and subtracts, cancelling the fixed
    per-call cost; the median of ``trials`` differences is reported.
    This is the measurement primitive ``bench.py`` uses.
    """
    n_small = max(n_blocks // 8, 1)
    for n in (n_small, n_blocks):  # compile/warm both span lengths
        compiled.steady_checksum(n)

    def span(n):
        t0 = time.perf_counter()
        compiled.steady_checksum(n)
        return time.perf_counter() - t0

    diffs = sorted(span(n_blocks) - span(n_small)
                   for _ in range(max(trials, 1)))
    dt = max(diffs[len(diffs) // 2], 1e-9)
    frames = (n_blocks - n_small) * compiled.block_size
    per_block = dt / (n_blocks - n_small)
    return {"rtf": (frames / compiled.sample_rate) / dt,
            "seconds_per_block": per_block,
            "us_per_block": per_block * 1e6,
            "frames": frames}


@contextlib.contextmanager
def trace(log_dir: str = "oscen_trace"):
    """``jax.profiler`` trace context (view with xprof/TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
