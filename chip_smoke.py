#!/usr/bin/env python3
"""On-card smoke test: the system's main path on an NVIDIA GPU.

    python3 chip_smoke.py               # one card: every phase below
    python3 chip_smoke.py --four-cards  # four cards: voice sharding only

Phases (one process; any failure exits nonzero before the last line):

1. device — JAX must report a GPU; prints its kind and count, and the
   card's name and power limit from ``nvidia-smi``.
2. main path — the 256-voice electric piano at 48 kHz through the entry
   points a user calls (``build_electric_piano``, ``Graph.compile``,
   raw MIDI through ``queue_event``, ``process_block``, ``render``,
   ``steady_checksum``) at B=1024 and B=4096: finite, non-silent output;
   the first blocks (a 256-note chord, steady blocks, blocks with a
   note-off and a note-on each) agree with ``mode="sample"`` on the card
   within 5e-4 at unit scale (the closed-form voice's stated bound,
   ops/pallas/additive.py); µs per block and the real-time factor.
3. kernels — each Triton kernel against its plain XLA reference at real
   widths (256 lanes and 1 lane, B=1024): deviation with its tolerance,
   and the time of both, measured here.
4. models — every other benchmarked graph renders two B=1024 blocks in
   block mode, compared with its sample-mode render on the card.

``--four-cards`` runs only the sharded electric piano (1,024 voices, 256
per card) against the same graph unsharded on card 0.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

SR = 48_000.0
VOICES = 256
STREAM_B, BULK_B = 1024, 4096
EP_TOL = 5e-4      # closed-form additive voice vs the per-sample path
MODEL_TOL = 1e-3   # block vs sample mode for the other graphs (see below)
SHARD_TOL = 1e-4   # 1,024-voice sum in another order: n·eps ≈ 6e-5


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str):
    if not ok:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ #
def device_phase(need: int):
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (platform {devs[0].platform!r})")
    check(len(devs) >= need, f"needs {need} GPUs, JAX found {len(devs)}")
    card = card_line()
    log(f"[device] platform=gpu kind={devs[0].device_kind} "
        f"count={len(devs)}")
    log(f"[device] {card}")
    return devs, card


def chord(synth, n: int, offset: int = 0):
    from oscen_tpu import raw_midi_event
    for i in range(n):
        synth.queue_event("midi_in", offset,
                          raw_midi_event([0x90, 36 + (i % 64), 100]))


def off_on(synth, k: int):
    """One note-off and one note-on, mid-block."""
    from oscen_tpu import raw_midi_event
    synth.queue_event("midi_in", 17, raw_midi_event([0x80, 36 + k % 64, 0]))
    synth.queue_event("midi_in", 17, raw_midi_event([0x90, 36 + k % 64, 90]))


def audio(outs, name="out"):
    return np.asarray(outs[name])


def deviation(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    check(a.shape == b.shape, f"shape {a.shape} != {b.shape}")
    check(np.isfinite(a).all() and np.isfinite(b).all(), "non-finite values")
    scale = max(1.0, float(np.abs(b).max()))
    dev = float(np.abs(a - b).max()) / scale
    return dev, dev <= tol


def rtf_of(us_per_block: float, B: int) -> float:
    return (B / SR) / (us_per_block * 1e-6)


def time_checksum(synth, B: int) -> float:
    """µs per block of the fused steady-state render (``steady_checksum``:
    all compute forced by the checksum fetch); best of three windows of
    up to ~0.5 s, at most 256 blocks each so the notes still sound."""
    ck = synth.steady_checksum(2)            # compile + warm
    check(np.isfinite(ck) and ck > 0.0, f"steady checksum {ck}")
    t0 = time.perf_counter()
    synth.steady_checksum(8)
    per = (time.perf_counter() - t0) / 8
    n = int(min(256, max(8, 0.5 / max(per, 1e-6))))
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        ck = synth.steady_checksum(n)
        us = (time.perf_counter() - t0) / n * 1e6
        best = us if best is None else min(best, us)
        check(np.isfinite(ck), f"steady checksum {ck}")
    return best


# ------------------------------------------------------------------ #
def main_path_phase(card: str):
    import jax
    from oscen_tpu.models.electric_piano import build_electric_piano

    g = build_electric_piano(VOICES)

    # streaming class: block mode vs sample mode, same events
    B = STREAM_B
    blk = g.compile(sample_rate=SR, block_size=B, mode="block")
    smp = g.compile(sample_rate=SR, block_size=B, mode="sample")
    plan = ["chord", "steady", "event", "event", "event", "steady"]
    worst = 0.0
    t0 = time.perf_counter()
    for i, what in enumerate(plan):
        for s in (blk, smp):
            if what == "chord":
                chord(s, VOICES)
            elif what == "event":
                off_on(s, i)
        a, b = audio(blk.process_block()), audio(smp.process_block())
        check(a.shape == (B, 2), f"block output shape {a.shape}")
        check(np.isfinite(a).all(), f"non-finite output in block {i}")
        check(np.abs(a).max() > 1e-3, f"silent output in block {i}")
        dev, ok = deviation(a, b, EP_TOL)
        worst = max(worst, dev)
        log(f"[main] B={B} block {i} ({what}) peak={np.abs(a).max():.4f} "
            f"max|block-sample|/scale={dev:.3e} tol={EP_TOL}")
        check(ok, f"block {i} deviates from sample mode: {dev:.3e}")
    log(f"[main] B={B} vs sample mode: worst {worst:.3e} <= {EP_TOL} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")

    # MIDI in every block: host prepass + staging + dispatch per block
    for k in range(4):              # compile the event-block variants
        off_on(blk, k)
        last = blk.process_block()
    jax.block_until_ready(last["out"])
    n_ev = 64
    t0 = time.perf_counter()
    for k in range(n_ev):
        off_on(blk, k)
        last = blk.process_block()
    jax.block_until_ready(last["out"])
    us_ev = (time.perf_counter() - t0) / n_ev * 1e6
    check(np.isfinite(audio(last)).all(), "non-finite event-block output")
    log(f"[main] B={B} MIDI every block: {us_ev:.1f} us/block "
        f"rtf={rtf_of(us_ev, B):.1f}x  [{card}]")
    us = time_checksum(blk, B)
    log(f"[main] B={B} steady_checksum: {us:.2f} us/block "
        f"rtf={rtf_of(us, B):.1f}x  [{card}]")

    # bulk class: render + steady checksum
    B = BULK_B
    bulk = g.compile(sample_rate=SR, block_size=B, mode="block")
    chord(bulk, VOICES)
    out = bulk.render(2 * B)["out"]
    check(out.shape == (2 * B, 2), f"render shape {out.shape}")
    check(np.isfinite(out).all() and np.abs(out).max() > 1e-3,
          "bulk render not finite or silent")
    us = time_checksum(bulk, B)
    log(f"[main] B={B} render peak={np.abs(out).max():.4f}; "
        f"steady_checksum: {us:.2f} us/block rtf={rtf_of(us, B):.1f}x  "
        f"[{card}]")


# ------------------------------------------------------------------ #
def loop_us(f, carry, x, n: int) -> float:
    """µs per call of ``f(carry, x) -> (carry, y)`` chained ``n`` times
    inside one jitted loop (one dispatch, so the time is the device's);
    every ``y`` feeds a checksum so no call is skipped."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(c, x):
        def body(_, s):
            c, acc = s
            c, y = f(c, x)
            return c, acc + sum(jnp.sum(v) for v in jax.tree.leaves(y))
        return jax.lax.fori_loop(0, n, body, (c, jnp.float32(0.0)))[1]

    jax.block_until_ready(run(carry, x))           # compile + warm
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(carry, x))
        us = (time.perf_counter() - t0) / n * 1e6
        best = us if best is None else min(best, us)
    return best


def kernel_cases(V: int, B: int, rng):
    """(name, step, init, xs, tolerance) for every lane-scan family at
    V lanes: the kernels' own step functions, so the plain reference is
    ``lax.scan`` of the same step.  Tolerances: the phase recurrence has
    no contractible op (bit-exact); the linear filters differ by FMA
    contraction only; LP18's tanh and the FM sines amplify those ulps
    through the nonlinear feedback."""
    import functools
    import jax.numpy as jnp
    from oscen_tpu.nodes.basic import fm_operator_step
    from oscen_tpu.nodes.filters import biquad_step, lp18_step, tpt_step
    from oscen_tpu.ops.pallas.fm import fm_chain_step, pivot_chain_step
    from oscen_tpu.ops.resample import (BRANCH_A_BETAS,
                                        allpass_cascade_step)
    from oscen_tpu.ops.scan import phase_step

    from oscen_tpu.nodes.filters import IirLowpass, _tpt_coefficients

    f32 = lambda a: jnp.asarray(a, jnp.float32)
    seq = lambda lo, hi: f32(rng.uniform(lo, hi, (B, V)))
    row = lambda lo, hi: f32(rng.uniform(lo, hi, (1, V)))
    zero = jnp.zeros((V,), jnp.float32)
    x = f32(rng.standard_normal((B, V)) * 0.5)
    cutoff, q = row(40.0, 12000.0), row(0.5, 4.0)
    h, g, _, k = _tpt_coefficients(SR, cutoff, q)
    biquad = IirLowpass._coefficients(SR, cutoff, q)
    chain_xs = (row(0.001, 0.05), row(0.001, 0.05), row(0.001, 0.05),
                seq(0.1, 1), seq(0.1, 1), seq(0.1, 1),
                row(0, 0.3), row(0, 0.3), row(0, 0.3), row(0, 1))
    return [
        ("phase", phase_step, f32(rng.uniform(0, 1, V)), seq(0, 0.1), 0.0),
        ("tpt_svf", tpt_step, (zero, zero), (x, h, g, k), 1e-5),
        ("biquad", biquad_step, (zero, zero), (x,) + biquad, 1e-5),
        ("lp18", lp18_step, (zero, zero, zero),
         (x, jnp.tan(row(0.001, 0.33) * jnp.pi), row(0.0, 1.9)), 1e-4),
        ("allpass_cascade",
         functools.partial(allpass_cascade_step, BRANCH_A_BETAS),
         ((zero, zero), (zero, zero)), x, 1e-5),
        ("fm_operator", fm_operator_step, (zero, zero),
         (row(0.001, 0.05), seq(-0.2, 0.2), row(0, 0.3), seq(0.2, 1),
          row(0.5, 1)), 1e-4),
        ("fm_chain", fm_chain_step, (zero,) * 6, chain_xs, 1e-4),
        ("pivot_chain", pivot_chain_step, (zero,) * 6, chain_xs, 1e-4),
    ]


def kernel_phase(card: str):
    import jax
    import jax.numpy as jnp
    from oscen_tpu.core.types import SampleRate
    from oscen_tpu.nodes.electric_piano import ElectricPianoVoice
    from oscen_tpu.ops.pallas import additive, recurrence

    rng = np.random.default_rng(0)
    B = STREAM_B
    rows = []
    with jax.default_matmul_precision("highest"):
        for V in (VOICES, 1):
            for name, step, init, xs, tol in kernel_cases(V, B, rng):
                def kern(i, x, step=step):
                    return recurrence._pallas_scan(step, i, x, B,
                                                   interpret=False)

                def plain(i, x, step=step):
                    return recurrence._plain_scan(step, i, x)

                got, ref = jax.jit(kern)(init, xs), jax.jit(plain)(init, xs)
                dev = max(deviation(a, b, tol)[0] for a, b in zip(
                    jax.tree.leaves(got), jax.tree.leaves(ref)))
                rows.append((name, V, dev, tol, loop_us(kern, init, xs, 20),
                             loop_us(plain, init, xs, 3)))

            # the fused additive voice vs the XLA closed form (+ mixdown)
            node, sr = ElectricPianoVoice(), SampleRate(SR)
            st = jax.vmap(lambda _: node.init_state(sr))(jnp.arange(V))
            vals = {e.name: jnp.full((V,), float(e.default), jnp.float32)
                    for e in node.INPUTS if e.kind.name == "VALUE"}
            st = jax.vmap(lambda s, v, i: node.on_gate(s, v, sr, i))(
                st, jnp.asarray(rng.uniform(0.3, 1, V), jnp.float32), vals)
            vals["frequency"] = jnp.asarray(rng.uniform(40, 3000, V),
                                            jnp.float32)
            ins = {k: jnp.broadcast_to(v[:, None], (V, B))
                   for k, v in vals.items()}

            def plain(s, i):
                s, out = jax.vmap(lambda s1, i1: node.process_block(
                    s1, i1, {}, sr, B))(s, i)
                return s, jnp.sum(out["output"], axis=0)

            def kern(s, i):
                s, out = node.kernel_block(s, i, sr, B, with_mix=True)
                return s, out["__fanin__output"]

            st, _ = jax.jit(plain)(st, ins)     # into the decay cycles
            dev = deviation(jax.jit(kern)(st, ins)[1],
                            jax.jit(plain)(st, ins)[1], EP_TOL)[0]
            rows.append(("additive_voice", V, dev, EP_TOL,
                         loop_us(kern, st, ins, 20),
                         loop_us(plain, st, ins, 20)))

    log(f"[kernels] B={B}, Triton kernel vs XLA's plain version, us per "
        f"call in a jitted loop  [{card}]")
    for name, V, dev, tol, t_k, t_p in rows:
        routed = (name != "additive_voice" or additive.kernel_pays(V, B))
        log(f"[kernels] {name:16s} V={V:3d} max dev/scale={dev:.3e} "
            f"tol={tol:g}  kernel {t_k:9.1f} us  xla {t_p:9.1f} us  "
            f"speedup {t_p / t_k:6.1f}x"
            + ("" if routed else "  (below kernel_pays: graphs use xla)"))
        check(dev <= tol, f"{name} V={V} deviates {dev:.3e} > {tol}")

    # the additive kernel end to end: the fused voice node against the
    # reference's two-node subgraph, whose closed forms XLA compiles
    from oscen_tpu.models.electric_piano import build_electric_piano
    for B in (STREAM_B, BULK_B):
        synths = {}
        for label, fused in (("kernel", True), ("xla", False)):
            s = build_electric_piano(VOICES, fused=fused).compile(
                sample_rate=SR, block_size=B, mode="block")
            chord(s, VOICES)
            s.process_block()
            synths[label] = s
        t = {}
        for label in ("kernel", "xla", "xla", "kernel"):   # in turns
            t[label] = min(t.get(label, 1e30),
                           time_checksum(synths[label], B))
        log(f"[kernels] additive_voice graph V={VOICES} B={B}: steady_checksum"
            f" kernel {t['kernel']:.2f} us/block  xla {t['xla']:.2f} us/block"
            f"  speedup {t['xla'] / t['kernel']:.2f}x  [{card}]")


# ------------------------------------------------------------------ #
def model_phase(card: str):
    """Two B=1024 blocks of every other benchmarked graph, block mode vs
    sample mode on the card.  MODEL_TOL at unit scale covers the block
    path's closed forms (f32 reassociation) and XLA's GPU
    transcendentals, which differ between the two compiled programs."""
    from oscen_tpu.models.fm_synth import build_fm_synth
    from oscen_tpu.models.pivot import build_pivot
    from oscen_tpu.models.poly_synth import build_poly_synth
    from oscen_tpu.models.simple import (build_saturator, build_simple_echo,
                                         build_simple_synth)
    from oscen_tpu.models.twin_peaks import build_twin_peaks

    B = STREAM_B
    rng = np.random.default_rng(1)
    noise = (rng.standard_normal(2 * B) * 0.3).astype(np.float32)
    models = [
        ("poly_synth", lambda: build_poly_synth(VOICES), None),
        ("fm_synth", lambda: build_fm_synth(VOICES), None),
        ("pivot", lambda: build_pivot(VOICES), None),
        ("readme_synth", build_simple_synth, None),
        ("simple_echo", build_simple_echo, "x"),
        ("saturator", lambda: build_saturator(factor=4), None),
        ("twin_peaks", build_twin_peaks, "audio_in"),
    ]
    for name, build, stream in models:
        t0 = time.perf_counter()
        g = build()
        outs = {}
        for mode in ("block", "sample"):
            s = g.compile(sample_rate=SR, block_size=B, mode=mode)
            if any(i.name == "midi_in" for i in s.ir.inputs):
                chord(s, VOICES)
            si = {stream: noise} if stream else None
            outs[mode] = next(iter(s.render(2 * B, stream_inputs=si)
                                   .values()))
        a, b = outs["block"], outs["sample"]
        check(np.isfinite(a).all(), f"{name}: non-finite output")
        check(np.abs(a).max() > 1e-4, f"{name}: silent output")
        dev, ok = deviation(a, b, MODEL_TOL)
        log(f"[models] {name:12s} peak={np.abs(a).max():.4f} "
            f"max|block-sample|/scale={dev:.3e} tol={MODEL_TOL} "
            f"({time.perf_counter() - t0:.1f} s incl. compile)")
        check(ok, f"{name}: block vs sample {dev:.3e} > {MODEL_TOL}")


# ------------------------------------------------------------------ #
def four_cards_phase(card: str):
    import jax
    from oscen_tpu.models.electric_piano import build_electric_piano
    from oscen_tpu.parallel.voices import shard_compiled_state, voice_mesh

    V, B = 4 * VOICES, STREAM_B
    g = build_electric_piano(V)
    one = g.compile(sample_rate=SR, block_size=B, mode="block")
    four = shard_compiled_state(
        g.compile(sample_rate=SR, block_size=B, mode="block"),
        voice_mesh(4))
    plan = ["chord", "steady", "event", "event", "event", "steady"]
    for i, what in enumerate(plan):
        for s in (one, four):
            if what == "chord":
                chord(s, V)
            elif what == "event":
                off_on(s, i)
        a, b = audio(four.process_block()), audio(one.process_block())
        check(np.isfinite(a).all() and np.abs(a).max() > 1e-3,
              f"sharded block {i} not finite or silent")
        dev, ok = deviation(a, b, SHARD_TOL)
        log(f"[four] V={V} B={B} block {i} ({what}) peak="
            f"{np.abs(a).max():.4f} max|4 cards - 1 card|/scale={dev:.3e} "
            f"tol={SHARD_TOL}")
        check(ok, f"sharded block {i} deviates {dev:.3e}")
    for label, s in (("4 cards", four), ("1 card", one)):
        us = time_checksum(s, B)
        log(f"[four] V={V} B={B} {label}: {us:.2f} us/block "
            f"rtf={rtf_of(us, B):.1f}x  [{card}]")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card voice-sharding phase")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import jax
    from oscen_tpu.utils.cache import enable_compile_cache
    log(f"[cache] {enable_compile_cache()}")
    devs, card = device_phase(4 if args.four_cards else 1)
    if args.four_cards:
        four_cards_phase(card)
    else:
        main_path_phase(card)
        kernel_phase(card)
        model_phase(card)
    log(f"[chip_smoke] all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
