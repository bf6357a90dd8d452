"""Benchmark: 256-voice electric piano real-time factor on one GPU.

Renders the flagship electric-piano model (the reference's headline
example at 16 voices on CPU — /root/reference/examples/electric-piano/
src/main.rs:205-209 — here 256 voices batched on the card: MIDI → voice
allocator → per-voice 32-harmonic additive voices → stereo tremolo)
and reports rendered audio throughput as a multiple of real time at 48 kHz.

Baseline: the reference publishes no numbers (BASELINE.md);
``vs_baseline = value / 1000`` (1000x real time as a fixed scale).

Prints JSON result lines: {"metric", "value", "unit", "vs_baseline", ...}.
BOTH latency classes are measured every run — B=4096 (bulk/offline, 85 ms)
and B=1024 (streaming, 21 ms; nearest the reference's 512-frame realtime
callbacks) — one JSON line each, the streaming line printed LAST so a
last-line consumer records the streaming-class number as the headline.
The FIRST valid measurement window is printed immediately; further windows
refine (re-print) the lines while the wall budget lasts — consumers should
take the LAST JSON line per metric.  The whole run is hard-capped:

* a supervisor process enforces ``OSCEN_BENCH_BUDGET_S`` (default 240 s)
  of total wall time — the measurement child is killed at the deadline and
  whatever JSON was already printed stands;
* a backend-init watchdog kills a child whose JAX backend bring-up hangs
  and retries with a short (<= 15 s) backoff while budget remains.

The supervisor imports no JAX, so only the child holds the card.
"""

import json
import os
import subprocess
import sys
import threading
import time

INIT_TIMEOUT_S = float(os.environ.get("OSCEN_BENCH_INIT_TIMEOUT_S", "75"))
RETRY_BACKOFF_S = 10.0   # between child attempts
CHILD_MARGIN_S = 4.0     # child stops measuring this far before its deadline


# --------------------------------------------------------------------------
# Supervisor: hard wall budget + init watchdog around the measurement child.
# --------------------------------------------------------------------------

def supervise() -> int:
    start = time.monotonic()
    budget = float(os.environ.get("OSCEN_BENCH_BUDGET_S", "420"))
    deadline = start + budget
    got_json = False
    attempt = 0
    while time.monotonic() < deadline - 2.0:
        attempt += 1
        remaining = deadline - time.monotonic()
        env = dict(os.environ)
        env["OSCEN_BENCH_CHILD_DEADLINE_S"] = str(max(5.0, remaining - 1.0))
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child",
             *[a for a in sys.argv[1:] if a != "--child"]],
            stdout=subprocess.PIPE, text=True, bufsize=1, env=env)

        state = {"json_at": None, "marker_at": None}

        def pump(proc=child, state=state):
            for line in proc.stdout:
                line = line.rstrip("\n")
                print(line, flush=True)  # forward everything to the driver
                s = line.strip()
                if s.startswith("{") and s.endswith("}"):
                    try:
                        json.loads(s)
                    except ValueError:
                        continue
                    state["json_at"] = time.monotonic()
                elif s.startswith("[bench]"):
                    state["marker_at"] = time.monotonic()

        reader = threading.Thread(target=pump, daemon=True)
        t_spawn = time.monotonic()
        reader.start()
        while child.poll() is None:
            now = time.monotonic()
            if now >= deadline:
                child.kill()
                break
            # Backend bring-up hang: no progress marker at all within the
            # init window — kill and retry rather than waiting out the
            # whole budget.
            if (state["marker_at"] is None and state["json_at"] is None
                    and now - t_spawn > INIT_TIMEOUT_S):
                print(f"[bench] attempt {attempt}: no backend progress in "
                      f"{INIT_TIMEOUT_S:.0f}s — killing child and retrying",
                      file=sys.stderr, flush=True)
                child.kill()
                break
            time.sleep(0.25)
        child.wait()
        reader.join(timeout=5.0)
        got_json = got_json or state["json_at"] is not None
        if got_json:
            return 0  # a result line is on stdout; refinement ended with it
        if time.monotonic() + RETRY_BACKOFF_S + 30.0 < deadline:
            print(f"[bench] attempt {attempt} produced no result — retrying "
                  f"in {RETRY_BACKOFF_S:.0f}s", file=sys.stderr, flush=True)
            time.sleep(RETRY_BACKOFF_S)
        else:
            break
    return 0 if got_json else 1


# --------------------------------------------------------------------------
# Measurement child.
# --------------------------------------------------------------------------

def measure() -> None:
    t_start = time.monotonic()
    child_deadline = t_start + float(
        os.environ.get("OSCEN_BENCH_CHILD_DEADLINE_S", "1e9"))
    stop_by = child_deadline - CHILD_MARGIN_S

    if os.environ.get("OSCEN_BENCH_TEST_HANG"):  # watchdog self-test hook
        time.sleep(1e9)

    print("[bench] importing jax", flush=True)
    import jax
    from oscen_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    print(f"[bench] devices ok: {jax.devices()}", flush=True)

    from oscen_tpu.models.electric_piano import build_electric_piano
    from oscen_tpu import raw_midi_event

    NUM_VOICES = 256
    SR = 48_000.0
    # BOTH latency classes are measured and recorded every run: B=4096 (85 ms, bulk/offline serving) and B=1024
    # (21 ms, streaming class — nearest the reference's 512-frame
    # realtime callbacks, /root/reference/examples/electric-piano/src/
    # main.rs:205-209).  One JSON line per block size, the streaming
    # B=1024 line printed LAST so a last-line consumer records the
    # streaming-class number as the round's headline.
    BLOCKS = [4096, 1024]
    mode = "block"
    model = "electric_piano"
    for a in sys.argv[1:]:
        if a.startswith("--mode="):
            mode = a.split("=", 1)[1]
        if a.startswith("--model="):
            model = a.split("=", 1)[1]
        if a.startswith("--block="):
            BLOCKS = [int(b) for b in a.split("=", 1)[1].split(",")]

    if model == "electric_piano":
        g = build_electric_piano(NUM_VOICES)
    elif model == "fm_synth":
        from oscen_tpu.models.fm_synth import build_fm_synth
        g = build_fm_synth(NUM_VOICES)
    elif model == "poly_synth":
        from oscen_tpu.models.poly_synth import build_poly_synth
        g = build_poly_synth(NUM_VOICES)
    elif model == "pivot":
        from oscen_tpu.models.pivot import build_pivot
        g = build_pivot(NUM_VOICES)
    elif model == "readme_synth":
        # BASELINE.md config 1: single-voice README synth
        from oscen_tpu.models.simple import build_simple_synth
        g = build_simple_synth()
        NUM_VOICES = 1
    elif model == "simple_echo":
        # BASELINE.md config 2: oscillator -> feedback delay line
        from oscen_tpu.models.simple import build_simple_echo
        g = build_simple_echo()
        NUM_VOICES = 1
    elif model == "saturator":
        # BASELINE.md config 4: 4x oversampled hard clip (multirate)
        from oscen_tpu.models.simple import build_saturator
        g = build_saturator(factor=4)
        NUM_VOICES = 1
    elif model == "twin_peaks":
        # the nih-twin-peaks plugin graph (dual-peak LP18 filter chain)
        from oscen_tpu.models.twin_peaks import build_twin_peaks
        g = build_twin_peaks()
        NUM_VOICES = 1
    else:
        raise SystemExit(f"unknown --model={model} (electric_piano, "
                         f"poly_synth, fm_synth, pivot, readme_synth, "
                         f"simple_echo, saturator, twin_peaks)")

    def audio_of(outs):
        return next(v for v in outs.values() if hasattr(v, "shape"))

    synths = {}

    def build_one(BLOCK):
        print(f"[bench] compiling {model} B={BLOCK} mode={mode}",
              flush=True)
        synth = g.compile(sample_rate=SR, block_size=BLOCK, mode=mode)
        has_midi = any(i.name == "midi_in" for i in synth.ir.inputs)
        # strike a large chord so every voice is active
        for i in range(NUM_VOICES if has_midi else 0):
            synth.queue_event("midi_in", 0,
                              raw_midi_event([0x90, 36 + (i % 64), 100]))
        # first block carries the events; steady-state rendering follows
        out = synth.process_block()
        jax.block_until_ready(audio_of(out))
        print(f"[bench] first block rendered B={BLOCK}", flush=True)
        synths[BLOCK] = synth

    if "--events" in sys.argv[1:]:
        # Event-dense streaming: one note-off + one
        # note-on queued EVERY block — the reference's actual workload
        # (params+MIDI inside every callback, electric-piano
        # main.rs:197-209).  Each block pays the full control path: host
        # prepass (MIDI parse, voice allocation, O(events) staging),
        # ONE packed host->device transfer, one jit dispatch.  Outputs
        # are not fetched per block (dispatch is async; a final
        # block_until_ready forces everything), so wall time measures
        # max(host per-block cost, device compute) — the streaming
        # ceiling.  Unlike the steady metric the per-block host work and
        # link latency are IN the measurement (that is the point), so
        # this number is also a function of host state.
        for BLOCK in BLOCKS:
            build_one(BLOCK)
            synth = synths[BLOCK]
            note = [0]

            def one(synth=synth, note=note):
                synth.queue_event("midi_in", 17, raw_midi_event(
                    [0x80, 36 + (note[0] % 64), 0]))
                synth.queue_event("midi_in", 17, raw_midi_event(
                    [0x90, 36 + (note[0] % 64), 90]))
                note[0] += 1
                return synth.process_block()

            for _ in range(8):   # compile event-block variants
                last = one()
            jax.block_until_ready(audio_of(last))
            print(f"[bench] events warmup done B={BLOCK}", flush=True)
            n = 200
            best = None
            while time.monotonic() + 5.0 < stop_by:
                t0 = time.perf_counter()
                for _ in range(n):
                    last = one()
                jax.block_until_ready(audio_of(last))
                us = (time.perf_counter() - t0) / n * 1e6
                best = us if best is None else min(best, us)
                rtf = (BLOCK / SR) / (best * 1e-6)
                print(json.dumps({
                    "metric": f"{model}_{NUM_VOICES}v_events_rtf_48k"
                              f"_b{BLOCK}",
                    "value": round(rtf, 2),
                    "unit": "x_realtime",
                    "vs_baseline": round(rtf / 200.0, 4),
                    "us_per_block": round(best, 1),
                    "block": BLOCK,
                    "events_per_block": 2,
                    "latency_ms": round(BLOCK / SR * 1e3, 1),
                }), flush=True)
        return

    # steady_checksum renders on device and fetches only a 4-byte energy
    # checksum (forcing all compute); timing two span lengths and
    # subtracting cancels the fixed per-call cost (dispatch, fetch),
    # leaving device throughput.
    n_small, n_large = 256, 2048

    def span(synth, n):
        t0 = time.perf_counter()
        synth.steady_checksum(n)
        return time.perf_counter() - t0

    # Median of 5 differences per window; windows repeat while the wall
    # budget lasts: the best window estimates capability, the median the
    # typical state.  The result lines are printed after the FIRST window
    # and refined (re-printed) after each later one.
    def window(synth):
        diffs = sorted(span(synth, n_large) - span(synth, n_small)
                       for _ in range(5))
        return max(diffs[2], 1e-9)

    def emit(BLOCK, windows):
        frames = (n_large - n_small) * BLOCK
        ws = sorted(windows)
        rtf = (frames / SR) / ws[0]                    # best (capability)
        rtf_median = (frames / SR) / ws[len(ws) // 2]  # typical
        print(json.dumps({
            "metric": f"{model}_{NUM_VOICES}v_rtf_48k"
                      + ("" if BLOCK == BLOCKS[-1] else f"_b{BLOCK}"),
            "value": round(rtf, 2),
            "unit": "x_realtime",
            "vs_baseline": round(rtf / 1000.0, 4),
            # both views: typical vs capability
            "median_window": round(rtf_median, 2),
            "us_per_block": round(ws[0] / (n_large - n_small) * 1e6, 2),
            "block": BLOCK,
            "latency_ms": round(BLOCK / SR * 1e3, 1),
            "windows": len(ws),
        }), flush=True)

    # Per-class incremental protocol: compile + warm + measure + EMIT
    # each block size COMPLETELY before starting the next, so the FIRST
    # JSON line exists after ONE model compile.  The headline class
    # (BLOCKS[-1], the streaming B=1024 by default) is processed FIRST;
    # the refinement loop re-emits in BLOCKS order so the headline line
    # also stays LAST.
    windows = {}
    for BLOCK in reversed(BLOCKS):   # headline class first
        build_one(BLOCK)
        for n in (n_small, n_large):
            synths[BLOCK].steady_checksum(n)
        print(f"[bench] warmup done B={BLOCK}", flush=True)
        windows[BLOCK] = [window(synths[BLOCK])]
        emit(BLOCK, windows[BLOCK])
        if time.monotonic() + 15.0 >= stop_by:
            break  # whatever was emitted stands
    live = [B for B in BLOCKS if B in windows]
    for B in live:   # ordered re-emit: the headline line is last even
        emit(B, windows[B])  # if no refinement window fits the budget
    MAX_WINDOWS = 7
    while (live
           and min(len(windows[B]) for B in live) < MAX_WINDOWS
           and time.monotonic() + 8.0 * len(live) < stop_by):
        time.sleep(min(6.0, max(0.0, stop_by - time.monotonic() - 2.0)))
        if time.monotonic() + 2.0 * len(live) >= stop_by:
            break
        for B in live:  # re-emit so the headline line stays last
            windows[B].append(window(synths[B]))
        for B in live:
            emit(B, windows[B])


if __name__ == "__main__":
    if "--child" in sys.argv[1:]:
        measure()
    else:
        sys.exit(supervise())
