"""Multi-device dry-run: run one rank's step of every (architecture x
input shape) on the production meshes without data, and record its
memory, cost and collectives (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference forces 512 host devices and compiles each cell.  The port
cannot start 512 ranks, so one process plays rank 0 of the mesh's world
under PyTorch's ``fake`` process-group backend (``fake_world``: every
collective returns at once, moving nothing) and runs the rank's train,
prefill or decode step once on ``meta`` tensors: shapes and dtypes
without storage.  Parameters, optimizer state and caches are the rank's
blocks (``abstract_params`` / ``abstract_cache`` under the cell's rules),
the batch is ``input_specs``'.  It is the one entry point of the port
that asks for no device: nothing in it computes, so it runs where there
is no card (and on the card's host, as ``chip_smoke.py`` runs it).

While the step runs, four counters watch it:

- ``torch.utils.flop_counter.FlopCounterMode``: the FLOPs of every
  matmul-like aten op (products, batched products, convolutions);
- ``kernels.cost.count_kernels``: the FLOPs and HBM bytes the port's
  kernels would take (their meta route: flash attention, weighted
  attention, the SSD scan), whose work no aten op shows;
- ``distributed.collectives.record_collectives``: every all-gather,
  all-reduce and reduce-scatter the rank issues, forward and backward;
- ``StepCounter`` (a ``TorchDispatchMode``): the bytes each aten op
  reads plus writes, views excepted (XLA's unfused "bytes accessed"),
  and the live bytes of the storages the step creates, each counted
  once, rounded up to the caching allocator's 512-byte blocks, and
  freed when its last tensor dies.

Flash attention's backward takes the card's route on meta, in either
dtype: the backward kernels, whose cost ``kernels.cost`` counts.  The
predictor's instruction encoder takes the card's path on meta (passes
of ``ENCODE_CHUNK`` rows), so the counts are the card's.

The record (``results/dryrun_torch/<arch>__<shape>__<mesh>.json``)
keeps the reference's keys, so ``roofline_report`` reads it:
``memory.{argument,output,temp}_bytes`` (the rank's parameters,
optimizer state, batch and caches; the step's new outputs; the peak of
live bytes less the arguments), ``cost.{flops,bytes_accessed}``,
``collectives`` ({op: {count, bytes, wire_bytes}}), under ``scanned``
for the step at full depth (the reference's scanned artifact), under
``unrolled_r1``/``unrolled_r2`` at 1 and 2 repeats of the layer
pattern, and ``extrapolated`` from those two (``extrapolate_costs``).
A cell the port refuses (a frontend under a sequence-sharded layout)
is recorded as skipped with the refusal.

Found by running every cell on meta: ``torch.bincount`` has no meta
kernel (its length follows the data's largest id); the MoE counts its
experts by a scatter of E slots instead (``moe.expert_counts``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, ShapeConfig, get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (
    LOGICAL_RULES_DECODE, LOGICAL_RULES_DECODE_LONG,
    LOGICAL_RULES_PREDICTOR, LOGICAL_RULES_PREFILL_SP, LOGICAL_RULES_TRAIN,
    LOGICAL_RULES_TRAIN_FSDP, LOGICAL_RULES_TRAIN_ZERO3, layout,
    use_layout, use_mesh_and_rules)
from repro_torch.kernels.cost import count_kernels
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_mesh, mesh_axis_sizes, num_chips
from repro_torch.launch.specs import input_specs
from repro_torch.training.train_loop import (TrainConfig,
                                             abstract_train_state,
                                             data_axes, make_train_step,
                                             rank_rows)

RESULTS_DIR = Path("results/dryrun_torch")
ALLOC_BLOCK = 512          # the CUDA caching allocator's rounding
PRODUCTION_MESHES = {False: ("pod_16x16", (16, 16), ("data", "model")),
                     True: ("multipod_2x16x16", (2, 16, 16),
                            ("pod", "data", "model"))}


def pick_rules(kind: str, shape: ShapeConfig, mesh, rules_name: str = ""):
    if rules_name == "fsdp":
        return LOGICAL_RULES_TRAIN_FSDP
    if rules_name == "zero3":
        return LOGICAL_RULES_TRAIN_ZERO3
    if rules_name == "sp":
        return LOGICAL_RULES_PREFILL_SP
    if kind != "decode":
        return LOGICAL_RULES_TRAIN
    sizes = mesh_axis_sizes(mesh)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    if shape.global_batch % dp != 0:
        return LOGICAL_RULES_DECODE_LONG
    return LOGICAL_RULES_DECODE


# --------------------------------------------------------------------------- #
# A fake world and the step's counters
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def fake_world(n: int):
    """The default process group as rank 0 of ``n`` under the ``fake``
    backend (its collectives move nothing); none for n = 1.  Refuses to
    replace a process group that is already up."""
    import torch.distributed as dist
    if n == 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized in this process")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=n,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensors(tree) -> list:
    """The tensors of nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _block(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


class StepCounter(TorchDispatchMode):
    """Bytes each aten op reads and writes (views excepted; the
    collectives, which ``record_collectives`` counts, excepted), and the
    live and peak bytes of the storages the step creates.  ``known``:
    tensors whose storages exist before the step (its arguments)."""

    def __init__(self, known=()):
        super().__init__()
        self.bytes_accessed = 0.0
        self.live = self.peak = 0
        self._storages = {}
        # held, so that their ids stay theirs while the step runs
        self._known = [t.untyped_storage() for t in known]
        for st in self._known:
            self._storages[id(st)] = None

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        size = _block(st.nbytes())

        def freed(_, key=key, size=size):
            self._storages.pop(key, None)
            self.live -= size
        self._storages[key] = weakref.ref(st, freed)
        self.live += size
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("c10d", "_c10d_functional"):
            return out
        outs = _tensors(out)
        if not func.is_view:
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages of ``tensors``, each rounded up to
    the caching allocator's blocks (what ``memory_allocated`` counts of
    them on the card)."""
    seen, total = set(), 0
    for t in tensors:
        key = id(t.untyped_storage())
        if key not in seen:
            seen.add(key)
            total += _block(t.untyped_storage().nbytes())
    return total


def analyze(run, args) -> dict:
    """Run ``run()`` once (the step on meta tensors; ``args`` what it
    holds before it starts) under the four counters; the reference's
    ``analyze_compiled`` keys, plus the collectives by direction and
    the kernels' meta-route work."""
    held = _tensors(args)
    arg_storages = {id(t.untyped_storage()) for t in held}
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, count_kernels() as kernels, \
            coll.record_collectives() as records, \
            StepCounter(held) as steps:
        out = run()
    seconds = time.perf_counter() - t0
    outs = _tensors(out)
    new_out = [t for t in outs if id(t.untyped_storage()) not in arg_storages]
    aliased = [t for t in outs if id(t.untyped_storage()) in arg_storages]
    by_direction = {}
    for d in ("forward", "backward"):
        by_direction[d] = rf.collectives_from_records(
            [r for r in records if r.direction == d])
    return {
        "memory": {
            "argument_bytes": storage_bytes(held),
            "output_bytes": storage_bytes(new_out),
            "temp_bytes": steps.peak,
            "code_bytes": None,
            "alias_bytes": storage_bytes(aliased),
        },
        "cost": {
            "flops": float(flops.get_total_flops()) + kernels.total_flops,
            "bytes_accessed": steps.bytes_accessed + kernels.total_bytes,
        },
        "collectives": rf.collectives_from_records(records),
        "collectives_by_direction": by_direction,
        "kernels": {name: {"calls": kernels.calls[name],
                           "flops": kernels.flops[name],
                           "bytes": kernels.bytes[name]}
                    for name in sorted(kernels.calls)},
        "run_s": seconds,
    }


def estimated_peak_bytes(analysis: dict) -> int:
    """The device's peak: the arguments plus the step's live peak."""
    m = analysis["memory"]
    return m["argument_bytes"] + m["temp_bytes"]


# --------------------------------------------------------------------------- #
# One rank's step of a cell
# --------------------------------------------------------------------------- #

def step_program(cfg, shape: ShapeConfig, mesh, tcfg: TrainConfig):
    """(run, args): the rank's step of the cell on meta under the active
    mesh and rules, and what it holds before it runs.  Train: the
    state and the global batch through ``make_train_step`` (which takes
    the rank's rows); prefill: the rank's rows through ``prefill_step``;
    decode: one token a row against the rank's cache blocks of
    ``seq_len`` positions, at the last one.  The CAPSim predictor
    (``predictor_cell_program``) trains and serves clips."""
    if rf.is_predictor(cfg):
        return predictor_cell_program(cfg, shape, mesh, tcfg)
    from repro_torch.launch.serve import _rank_rows
    from repro_torch.models import transformer as tfm
    kind, (B, S) = shape.kind, (shape.global_batch, shape.seq_len)
    params = tfm.abstract_params(cfg, mesh)
    batch = input_specs(cfg, shape, kind)
    if kind == "train":
        state = abstract_train_state(params, tcfg)
        step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), tcfg)
        return (lambda: step(state, batch)), (state, batch)
    if kind == "prefill":
        lay = layout(B, S)
        rows = _rank_rows(batch, lay)

        def prefill():
            with use_layout(lay):
                return tfm.prefill_step(params, rows, cfg)
        return prefill, (params, rows)
    lay = layout(B, 1, S)
    rows = _rank_rows(batch, lay)
    caches = tfm.abstract_cache(cfg, B, S, mesh=mesh)

    def decode():
        with use_layout(lay):
            return tfm.decode_step(params, rows, cfg, caches, S - 1)
    return decode, (params, rows, caches)


def predictor_cell_program(cfg, shape: ShapeConfig, mesh,
                           tcfg: TrainConfig):
    """The CAPSim predictor's cell (the counterpart of the reference's
    ``predictor.lower_cell``; nothing is lowered here): under
    ``LOGICAL_RULES_PREDICTOR`` the weights replicate and the clips split
    over every mesh axis.  Train: ``mape_loss`` through
    ``make_train_step``; serve: ``predict_step`` on the rank's clips."""
    from repro_torch.core import predictor as pred
    params = pred.abstract_params(cfg)
    batch = input_specs(cfg, shape, shape.kind)
    if shape.kind == "train":
        state = abstract_train_state(params, tcfg)
        step = make_train_step(lambda p, b: pred.mape_loss(p, b, cfg), tcfg)
        return (lambda: step(state, batch)), (state, batch)
    rows = rank_rows(batch, mesh, data_axes(mesh, shape.global_batch))

    def serve():
        with torch.no_grad():
            return pred.predict_step(params, rows, cfg)
    return serve, (params, rows)


def measure_cell(cfg, shape: ShapeConfig, mesh, rules,
                 tcfg: TrainConfig) -> dict:
    """``analyze`` of the rank's step of the cell, on ``mesh`` (a
    ``launch.mesh.Mesh`` over the fake world, or None) under
    ``rules``."""
    if mesh is None:
        return analyze(*step_program(cfg, shape, None, tcfg))
    with use_mesh_and_rules(mesh, rules):
        return analyze(*step_program(cfg, shape, mesh, tcfg))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             optimizer: str = "sgdm", extrapolate: bool = True,
             out_dir: Path = RESULTS_DIR, overrides: dict = None,
             rules_name: str = "", microbatches: int = 1,
             accum_dtype: str = "float32", opt_state_dtype: str = "float32",
             tag: str = "") -> dict:
    """Dry-run one cell on a production mesh and write its record."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    mesh_name, shape_, axes = PRODUCTION_MESHES[multi_pod]
    suffix = f"__{tag}" if tag else ""
    fname = f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    out_dir.mkdir(parents=True, exist_ok=True)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if shape_name in cfg.skipped_shapes:
        record["skipped"] = cfg.skip_reason
        (out_dir / fname).write_text(json.dumps(record, indent=1))
        return record
    shape = cfg.shapes()[shape_name]
    tcfg = TrainConfig(optimizer=optimizer, microbatches=microbatches,
                       accum_dtype=accum_dtype,
                       opt_state_dtype=opt_state_dtype)
    record.update({"kind": shape.kind, "chips": math.prod(shape_),
                   "optimizer": optimizer})
    if rules_name:
        record["rules"] = rules_name
    if microbatches > 1:
        record["microbatches"] = microbatches
    if overrides:
        record["overrides"] = {k: str(v) for k, v in overrides.items()}
    with fake_world(math.prod(shape_)):
        mesh = make_mesh(shape_, axes, "cpu")
        record["chips"] = num_chips(mesh)
        rules = (LOGICAL_RULES_PREDICTOR if rf.is_predictor(cfg)
                 else pick_rules(shape.kind, shape, mesh, rules_name))
        try:
            record["scanned"] = measure_cell(cfg, shape, mesh, rules, tcfg)
        except NotImplementedError as e:
            record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                      "skipped": f"the port refuses it: {e}"}
            (out_dir / fname).write_text(json.dumps(record, indent=1))
            return record
        record["run_s"] = round(record["scanned"]["run_s"], 2)
        print(f"[{arch} x {shape_name} x {mesh_name}] ran on meta in "
              f"{record['run_s']:.1f}s; memory:")
        print(" ", record["scanned"]["memory"])
        if extrapolate and not rf.is_predictor(cfg):
            per_layer = {r: measure_cell(
                cfg.replace(num_layers=r * cfg.pattern_len), shape, mesh,
                rules, tcfg) for r in (1, 2)}
            record["unrolled_r1"] = per_layer[1]
            record["unrolled_r2"] = per_layer[2]
            record["extrapolated"] = extrapolate_costs(
                per_layer[1], per_layer[2], cfg.num_repeats)
    (out_dir / fname).write_text(json.dumps(record, indent=1))
    return record


def extrapolate_costs(r1: dict, r2: dict, repeats: int) -> dict:
    """cost(R) = outside + R*body, from measurements at R=1 and R=2."""
    def lin(a, b):
        if a is None or b is None:
            return None
        body = b - a
        outside = a - body
        return outside + repeats * body

    out = {"flops": lin(r1["cost"]["flops"], r2["cost"]["flops"]),
           "bytes_accessed": lin(r1["cost"]["bytes_accessed"],
                                 r2["cost"]["bytes_accessed"])}
    colls = {}
    keys = set(r1["collectives"]) | set(r2["collectives"])
    for k in keys:
        c1 = r1["collectives"].get(k, {"count": 0, "bytes": 0,
                                       "wire_bytes": 0})
        c2 = r2["collectives"].get(k, {"count": 0, "bytes": 0,
                                       "wire_bytes": 0})
        colls[k] = {kk: lin(float(c1[kk]), float(c2[kk]))
                    for kk in ("count", "bytes", "wire_bytes")}
    out["collectives"] = colls
    out["wire_bytes_total"] = sum(v["wire_bytes"] for v in colls.values())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimizer", default="sgdm")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--rules", default="", help="'' (default) | fsdp")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--accum-dtype", default="float32")
    ap.add_argument("--opt-state-dtype", default="float32")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. capacity_factor=1.0")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = eval(v)  # noqa: S307 — CLI-local literals
        except Exception:
            pass
        overrides[k] = v

    out_dir = Path(args.out)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = []
        for name in ARCH_NAMES:
            cfg = get_config(name)
            for sname in cfg.shape_names:
                cells.append((name, sname))
            for sname in cfg.skipped_shapes:
                cells.append((name, sname))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, sname in cells:
        for mp in meshes:
            mesh_name = PRODUCTION_MESHES[mp][0]
            suffix = f"__{args.tag}" if args.tag else ""
            fname = out_dir / f"{arch}__{sname}__{mesh_name}{suffix}.json"
            if args.skip_existing and fname.exists():
                print(f"skip existing {fname.name}")
                continue
            try:
                run_cell(arch, sname, mp, optimizer=args.optimizer,
                         extrapolate=not args.no_extrapolate,
                         out_dir=out_dir, rules_name=args.rules,
                         microbatches=args.microbatches, tag=args.tag,
                         accum_dtype=args.accum_dtype,
                         opt_state_dtype=args.opt_state_dtype,
                         overrides=overrides or None)
            except Exception as e:  # noqa: BLE001 — record and continue
                print(f"FAILED {arch} x {sname} x {mesh_name}: {e}")
                traceback.print_exc()
                failures.append((arch, sname, mesh_name, str(e)))
    if failures:
        print("\n== FAILURES ==")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall requested dry-run cells ran OK")


if __name__ == "__main__":
    main()
