"""Multi-pod dry run on the meta device (port of ``repro.launch.dryrun``).

For every assigned (architecture x input-shape) cell, build the cell and
run its step once on

  * the single-pod production mesh (16, 16)  = 256 ranks, and
  * the two-pod mesh             (2, 16, 16) = 512 ranks,

in one host process: a ``fake`` process group of 512 ranks stands in for
the cards (its collectives move nothing), and every tensor is on the
``meta`` device (shapes and dtypes, no data).  The process runs the
program of rank 0, so what it measures is one rank's (its share of the
batch and, under ``fsdp_cp``, its block of the sequence):

* ``bytes_per_device`` — its arguments' local shards (parameters,
  optimizer state, cache, batch) plus the peak of the storage its step
  allocates (intermediates and outputs: an eager step reuses no
  argument's buffer, a train step updates its own in place), tracked by a
  ``TorchDispatchMode`` (each new storage counted once, released by weakref
  finalizers when the last tensor on it that the mode saw has died;
  storage that DTensor's own dispatch allocates and frees inside one
  operation is not seen);
* FLOPs — ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry) over the aten operations of the step, counted by the same
  mode (every layer runs: no scan to correct for).  ``FlopCounterMode``
  itself is not entered: its module tracker holds every module's output
  until backward, which the memory reading would count (a 40-fold
  inflation on internvl2-76b's train cell);
* the bytes it moves — its arguments read once and every storage it
  writes written once (a lower bound: a second read of an intermediate is
  not counted);
* collective bytes — the outputs of the c10d operations it issues.

Each is scaled by the ranks for the roofline (``telemetry.roofline``,
against one H100 per rank).  No time here is a card's: the terms are the
data sheet's rates applied to these counts.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod-only|
      --single-pod-only] [--depth-periods N] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs.base import SHAPES
from ..dist import sharding
from ..dist.group import init_local
from ..models.registry import ARCHS, get_config
from ..telemetry.roofline import H100, model_flops, roofline
from .mesh import make_production_mesh
from .steps import build_cell, depth_variant, skip_reason, valid_cells

WORLD = 512


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepMeter(TorchDispatchMode):
    """FLOPs, peak live bytes, bytes written and collective bytes of the
    aten operations run in its extent (see the module docstring).  Storage is
    keyed by its ``StorageImpl``: the first output on a storage that no
    argument holds counts it, every later output on it (a view) joins its
    group, and the storage is released when the last tensor of its group
    dies."""

    def __init__(self, held=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.formulas = flop_registry
        self.flops = 0
        self.held = {_key(_local(t)) for t in held}
        self.groups: dict = {}          # storage key -> [tensors alive, bytes]
        self.live = 0
        self.peak = 0
        self.written = 0
        self.collective = 0

    def _release(self, key) -> None:
        group = self.groups[key]
        group[0] -= 1
        if group[0] == 0:
            self.live -= group[1]
            del self.groups[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        formula = self.formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **(kwargs or {}), out_val=out)
        name = func.__name__
        if name.startswith(("wait_tensor", "_wrap_tensor_autograd")):
            return out                  # a collective's result, rewrapped
        coll = func.namespace in ("c10d", "_c10d_functional")
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            t = _local(t)
            if coll:
                self.collective += t.numel() * t.element_size()
            key = _key(t)
            if key in self.held:
                continue
            group = self.groups.get(key)
            if group is None:
                nbytes = t.untyped_storage().nbytes()
                group = self.groups[key] = [0, nbytes]
                self.written += nbytes
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            group[0] += 1
            weakref.finalize(t, self._release, key)
        return out


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _held(cell) -> list:
    """Every tensor that lives before the step: its arguments, the plan's
    payloads and the Runtime's parameters."""
    out = _tensors(cell.args) + list(cell.runtime.params.values())
    if cell.runtime.plan is not None:
        out += _plan_tensors(cell.runtime.plan)
    return out


def _arg_bytes(tree, specs, mesh) -> int:
    """Local bytes of an argument tree: a DTensor's own block, a plain
    tensor's block under its spec (``None`` or "replicated": whole)."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_arg_bytes(v, specs.get(k) if isinstance(specs, dict)
                              else specs, mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Tensor):
        return sum(_arg_bytes(v, specs, mesh) for v in tree)
    if hasattr(tree, "to_local"):
        loc = tree.to_local()
        return loc.numel() * loc.element_size()
    if isinstance(tree, torch.Tensor):
        if isinstance(specs, sharding.PartitionSpec):
            return sharding.local_bytes(tree, mesh, specs)
        return tree.numel() * tree.element_size()
    if hasattr(tree, "layers"):                       # a PimPlan
        return sum(t.numel() * t.element_size() for t in _plan_tensors(tree))
    return 0


def _plan_tensors(plan):
    import dataclasses
    out = []
    for lp in plan.layers.values():
        for f in dataclasses.fields(lp):
            v = getattr(lp, f.name)
            if isinstance(v, torch.Tensor):
                out.append(v)
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             depth_periods: int = 0, with_roofline: bool = True,
             out_dir=None, verbose: bool = True) -> dict:
    """One (arch x shape x mesh) dry-run cell -> its record."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    rec = {"arch": arch, "shape": shape_name,
           "mesh": sharding.mesh_str(mesh), "chips": chips, "status": "ok"}
    reason = skip_reason(arch, shape_name)
    if reason:
        rec.update(status="skip", reason=reason)
        return rec
    try:
        t0 = time.time()
        cfg = get_config(arch)
        if depth_periods:
            cfg = depth_variant(cfg, depth_periods)
            rec["depth_periods"] = depth_periods
        cell = build_cell(arch, mesh, shape_name, cfg=cfg)
        rec["build_s"] = round(time.time() - t0, 2)
        a_bytes = sum(_arg_bytes(a, s, mesh)
                      for a, s in zip(cell.args, cell.in_specs))
        t1 = time.time()
        with StepMeter(_held(cell)) as meter:
            out = cell.run()
        rec["run_s"] = round(time.time() - t1, 2)
        out_bytes = 0
        if cell.shape.kind != "train":      # a train step updates its args
            out_bytes = sum(_local(t).numel() * _local(t).element_size()
                            for t in _tensors(out))
        # eager steps donate nothing: an output is a new storage that the
        # peak already holds, and the arguments stay live beside it
        rec["memory"] = {"argument_bytes": int(a_bytes),
                         "output_bytes": int(out_bytes),
                         "temp_bytes": int(meter.peak)}
        rec["bytes_per_device"] = int(a_bytes + meter.peak)
        flops = float(meter.flops)
        moved = float(a_bytes + meter.written)
        rec["per_device"] = {"flops": flops, "bytes_moved": moved,
                             "collective_bytes": float(meter.collective)}
        rec["fits_h100"] = rec["bytes_per_device"] <= H100.hbm_bytes
        if with_roofline:
            mf = model_flops(cfg, SHAPES[shape_name])
            rep = roofline(arch, shape_name, rec["mesh"], chips,
                           flops * chips, moved * chips,
                           float(meter.collective) * chips, mf,
                           bytes_per_device=rec["bytes_per_device"], hw=H100)
            rec["roofline"] = rep.row()
        if verbose:
            r = rec.get("roofline", {})
            print(f"[ok] {arch:22s} {shape_name:12s} mesh={rec['mesh']:8s} "
                  f"run={rec['run_s']:6.1f}s "
                  f"mem/dev={rec['bytes_per_device'] / 1e9:8.2f}GB "
                  + (f"bottleneck={r.get('bottleneck', '-'):10s} "
                     f"roofline={r.get('roofline_frac', 0):.4f}"
                     if r else ""), flush=True)
    except Exception as e:                      # a cell's failure is data
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=12)
        if verbose:
            print(f"[FAIL] {arch} {shape_name} mesh={rec['mesh']}: "
                  f"{rec['error']}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}_{shape_name}_{rec['mesh']}.json".replace("/", "-")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--depth-periods", type=int, default=0,
                    help="run depth_variant(cfg, N) instead of full depth")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--out", default=None, help="JSON output directory")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in valid_cells(a)]
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        shapes = [args.shape] if args.shape else valid_cells(args.arch)
        cells = [(args.arch, s) for s in shapes]
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)

    # DTensor warns on every two-axis gather of a batch-split weight
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    import torch.distributed as dist
    if not dist.is_initialized():
        init_local("fake", world=WORLD)
    print(f"ranks={dist.get_world_size()} cells={len(cells)} "
          f"meshes={['multi' if m else 'single' for m in meshes]}",
          flush=True)
    t0 = time.time()
    results, failed = [], 0
    for multi_pod in meshes:
        for arch, shape_name in cells:
            rec = run_cell(arch, shape_name, multi_pod=multi_pod,
                           depth_periods=args.depth_periods,
                           with_roofline=not args.no_roofline,
                           out_dir=args.out)
            results.append(rec)
            failed += rec["status"] == "fail"
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skip" for r in results)
    print(f"\ndry-run: {ok} ok, {skip} skip (N/A cells), {failed} FAIL "
          f"of {len(results)} in {time.time() - t0:.1f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
