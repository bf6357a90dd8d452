"""Deployable model bundles — the build-tooling analogue of the
reference's ``xtask bundle`` (SURVEY §1 L7: the reference packages its
apps as deployable CLAP/VST3 bundles via its ``xtask`` crate).  An
accelerator-serving framework's deployable unit is a *compiled graph
plus its state*: this module saves the lowered IR, the full engine
checkpoint (device state incl. published assets, host
params/ramps, control state, pending events) and a manifest, and loads
it back into a ready-to-render :class:`CompiledGraph` on any machine
with oscen_tpu installed — no model-building code required.

Layout of a bundle directory::

    manifest.json   name, sample rate, block size, mode, I/O table,
                    node inventory, param specs (the nih_params export)
    ir.pkl          the lowered IR (library node instances pickle;
                    custom nodes need their class importable)
    state.pkl       full checkpoint (utils/checkpoint.py format)

Use: build+voice+play on a dev box, ``save_bundle(synth, path)``, ship
the directory, ``synth = load_bundle(path)`` in the serving process.
Restores are bit-exact (the checkpoint layer's guarantee).
"""

from __future__ import annotations

import json
import os
import pickle

from .checkpoint import load_state, save_state

_FORMAT = 1


def save_bundle(compiled, path: str) -> None:
    """Write ``compiled`` (a CompiledGraph) as a bundle directory."""
    from ..graph.ir import Kind

    os.makedirs(path, exist_ok=True)
    manifest = {
        "format": _FORMAT,
        "graph": compiled.ir.name,
        "sample_rate": compiled.sample_rate,
        "block_size": compiled.block_size,
        "mode": compiled.mode,
        "inputs": [{"name": i.name, "kind": i.kind.name.lower(),
                    "default": getattr(i, "default", None)}
                   for i in compiled.ir.inputs],
        "outputs": [{"name": o.name, "kind": o.kind.name.lower(),
                     "channels": getattr(o, "channels", 1)}
                    for o in compiled.ir.outputs],
        "nodes": sorted(
            {f"{type(inst.node).__name__}"
             + (f"[{inst.count}]" if inst.count > 1 else "")
             for inst in compiled.ir.nodes.values()}),
        "params": {
            name: {"min": spec.min, "max": spec.max, "log": spec.log,
                   "unit": spec.unit, "step": spec.step,
                   "display_name": spec.display_name}
            for name, spec in _param_specs(compiled).items()},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=float)
    with open(os.path.join(path, "ir.pkl"), "wb") as f:
        pickle.dump(compiled.ir, f)
    save_state(compiled, os.path.join(path, "state.pkl"))


def _param_specs(compiled):
    out = {}
    for gi in compiled.ir.inputs:
        spec = getattr(gi, "spec", None)
        if spec is not None:
            out[gi.name] = spec
    return out


def load_bundle(path: str, jit: bool = True):
    """Reconstruct a ready-to-render CompiledGraph from a bundle."""
    from ..graph.compile import CompiledGraph

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"unknown bundle format {manifest.get('format')}")
    with open(os.path.join(path, "ir.pkl"), "rb") as f:
        ir = pickle.load(f)
    compiled = CompiledGraph(ir, sample_rate=manifest["sample_rate"],
                             block_size=manifest["block_size"],
                             mode=manifest["mode"], jit=jit)
    load_state(compiled, os.path.join(path, "state.pkl"))
    return compiled


__all__ = ["save_bundle", "load_bundle"]
