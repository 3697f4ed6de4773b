"""Multi-pod dry-run: trace every (arch x shape) cell's step on the
production mesh from fake tensors only (nothing is allocated), and
record what one device of the mesh computes, reads and exchanges, for
the roofline analysis.

Counterpart of ``repro.launch.dryrun``, with its variants, cells,
record keys and CLI.  The reference lowers and compiles the step with
XLA and reads ``memory_analysis`` / ``cost_analysis`` / the HLO's
collectives.  The port *traces* it instead: the mesh is a
``DeviceMesh`` over a fake world (``launch.mesh``), params, optimizer
state and batch are DTensors placed by the recipe's specs (each
sanitized as the reference's ``_shard_sds`` does), their local shards
are fake tensors, and :class:`roofline.trace.StepTrace` counts each op
DTensor runs on one rank's shard:

* ``cost_analysis.flops``: matrix-product FLOPs **per device**
  (replicated work counted on every device that does it);
* ``cost_analysis["bytes accessed"]``: each op's local input and output
  bytes, summed op by op -- an *unfused* count, an upper bound on what a
  fused program moves;
* ``collectives``: result bytes by kind (``roofline.collective_bytes``);
* ``memory_analysis``: ``argument_size_in_bytes`` (the local bytes of
  params, optimizer state and batch / cache) and ``output_size_in_bytes``;
  ``temp_size_in_bytes`` is None: a peak of live temporaries taken from
  a fake-tensor trace depends on the torch release (``roofline.trace``).

``lower_seconds`` is the trace's wall time; nothing is compiled
(``compile_seconds`` 0.0, ``hlo_bytes`` None).  Attention traces the
plain ``attend``, which the reference also lowers.  ``scan_unroll`` has
no effect: the port's layer stacks are Python loops, so every layer is
always counted.  bf16 products are counted as the card runs them (the
trace's one fusion, ``roofline.trace``).  The decode step's ``pos`` is
``seq_len - 1``: one token against a full cache.

Each process holds one default process group, so a process traces one
mesh size; ``--spawn`` runs a process a cell.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all --spawn        # every cell
  python -m repro_torch.launch.dryrun --all --multi-pod    # 2x16x16 pass
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Dict

import torch

from ..configs import SHAPES, get_config, list_archs, shape_supported
from ..distributed.sharding import (P, ShardingRecipe, cache_specs,
                                    from_local, is_dtensor, local_shape,
                                    make_recipe, param_spec, param_specs,
                                    placements, sanitize_spec, use_recipe)
from ..models import build
from ..models.registry import input_specs, param_shapes
from ..optim import make_optimizer
from ..roofline.analysis import collective_bytes, roofline_terms
from ..tree import leaves, leaves_with_path, tree_map, unflatten
from .mesh import FAKE_DEVICE, make_mini_mesh, make_production_mesh
from .steps import make_serve_step, make_train_step

DEFAULT_OUT = "experiments/dryrun_torch"


# --------------------------------------------------------------- variants ---
# name -> fn(cfg, spec, recipe) -> (cfg, recipe).
def _baseline(cfg, spec, recipe):
    return cfg, recipe


def _no_seq_parallel(cfg, spec, recipe):
    """Prefill without sequence sharding (activations batch-sharded only)."""
    sites = {k: P(recipe.dp, None, None) for k in ("residual",)}
    sites["act_ff"] = P(recipe.dp, None, recipe.tp)
    sites["logits"] = P(recipe.dp, None, recipe.tp)
    sites["moe_disp"] = P(recipe.tp, None, None)
    return cfg, dataclasses.replace(recipe, seq=None, sites=sites)


def _no_remat(cfg, spec, recipe):
    return dataclasses.replace(cfg, remat=False), recipe


def _fp32_params(cfg, spec, recipe):
    return dataclasses.replace(cfg, dtype="float32"), recipe


DEDUP_NUM_VARIANTS = 6       # resident model variants (paper Tab. 1)
DEDUP_BLOCK = (256, 256)     # storage block (DESIGN.md §2)


def _pool_params(params_sds, cfg, ratio: float):
    """Replace every >=1 MiB 2-D-blockable weight with (pool, block_map):
    the pool holds the distinct blocks of DEDUP_NUM_VARIANTS variants at
    the given distinct fraction; the map belongs to the served variant.

    Returns (pooled tensors keyed by "/"-joined path, unpool_fn); the
    pooled tensors are made as ``params_sds``' leaves are (meta, or fake
    under a ``FakeTensorMode``).
    """
    from ..core.blocks import make_grid
    bh, bw = DEDUP_BLOCK

    flat = list(leaves_with_path(params_sds))
    pooled: Dict[str, torch.Tensor] = {}
    plans = {}
    for path, leaf in flat:
        key = "/".join(str(p) for p in path)
        size = leaf.numel() * leaf.element_size()
        if leaf.dim() >= 2 and size >= (1 << 20):
            shape2d = (math.prod(leaf.shape[:-1]), int(leaf.shape[-1]))
            grid = make_grid(shape2d, (bh, bw))
            n_blocks = grid.num_blocks
            n_distinct = max(1, int(n_blocks * DEDUP_NUM_VARIANTS * ratio))
            n_distinct = -(-n_distinct // 512) * 512   # shardable on any mesh
            pooled[key + "#pool"] = torch.empty(
                (n_distinct, bh, bw), dtype=leaf.dtype, device=leaf.device)
            pooled[key + "#map"] = torch.empty(
                (n_blocks,), dtype=torch.int32, device=leaf.device)
            plans[key] = (tuple(leaf.shape), shape2d, grid)
        else:
            pooled[key] = leaf

    def unpool(pooled_vals):
        out = []
        for path, _ in flat:
            key = "/".join(str(p) for p in path)
            if key in plans:
                shape, shape2d, grid = plans[key]
                pool = pooled_vals[key + "#pool"]
                bmap = pooled_vals[key + "#map"]
                blocks = torch.index_select(pool, 0, bmap)
                if is_dtensor(blocks):
                    # the served variant's blocks, gathered to every
                    # device before the weight is reassembled (DTensor
                    # cannot view a block-sharded weight as a matrix)
                    from torch.distributed.tensor import Replicate
                    blocks = blocks.redistribute(
                        blocks.device_mesh,
                        [Replicate()] * blocks.device_mesh.ndim)
                gh, gw = grid.grid
                w = (blocks.reshape(gh, gw, bh, bw)
                           .permute(0, 2, 1, 3)
                           .reshape(gh * bh, gw * bw))
                w = w[: shape2d[0], : shape2d[1]].reshape(shape)
                out.append(w)
            else:
                out.append(pooled_vals[key])
        return unflatten(params_sds, out)

    return pooled, unpool


def _unrolled(cfg, spec, recipe):
    """The reference's accounting mode (unrolled layer scans).  The
    port's layers are a Python loop and always counted, so the config's
    ``scan_unroll`` changes nothing in the trace."""
    return dataclasses.replace(cfg, scan_unroll=True), recipe


def _nsp_unrolled(cfg, spec, recipe):
    cfg, recipe = _no_seq_parallel(cfg, spec, recipe)
    return _unrolled(cfg, spec, recipe)


def _train_sp_unrolled(cfg, spec, recipe):
    """Sequence-parallel training activations: the residual stream shards
    over `model` as well, dividing the activation temps by the TP width."""
    sites = {
        "residual": P(recipe.dp, recipe.tp, None),
        "act_ff":   P(recipe.dp, recipe.tp, None),
        "logits":   P(recipe.dp, recipe.tp, None),
        "moe_disp": P(recipe.tp, None, None),
    }
    recipe = dataclasses.replace(recipe, seq=recipe.tp, sites=sites)
    return dataclasses.replace(cfg, scan_unroll=True), recipe


VARIANTS = {
    "baseline": _baseline,
    "unrolled": _unrolled,
    "no_seq_parallel": _no_seq_parallel,
    "nsp_unrolled": _nsp_unrolled,
    "train_sp_unrolled": _train_sp_unrolled,
    "no_remat": _no_remat,
    "fp32_params": _fp32_params,
    # dedup_serving handled specially in lower_cell (wraps the step and
    # re-shapes the weight inputs into pool+map form); list for CLI.
    "dedup_serving": _unrolled,
    "dedup_serving_dense_ref": _unrolled,
    # sharded page-pool serving (serving/shard_pool.py at pod scale):
    # the block maps shard with the pool instead of replicating, so the
    # trace also counts the map-distribution collectives.
    "dedup_serving_sharded": _unrolled,
}


# ---------------------------------------------------------------- helpers ---
def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _local_bytes(tree) -> int:
    """Bytes one rank holds of a tree of DTensors (and plain tensors)."""
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _shard_sds(tree, spec_tree, mesh, requires_grad: bool = False):
    """DTensors of ``tree``'s shapes and dtypes laid out by ``spec_tree``
    (each spec sanitized for its shape, as the reference's
    ``_shard_sds``), whose local shards are new tensors on the fake
    mesh's device (fake under the trace)."""
    def f(t, spec):
        spec = sanitize_spec(spec, tuple(t.shape), mesh)
        local = torch.empty(local_shape(tuple(t.shape), spec, mesh),
                            dtype=t.dtype, device=FAKE_DEVICE)
        d = from_local(local, mesh, placements(spec, mesh), t.shape)
        return d.requires_grad_() if requires_grad else d
    return tree_map(f, tree, spec_tree)


def _relayout(w, spec, mesh):
    """``w`` (a DTensor) laid out by ``spec``, sanitized for its shape."""
    spec = sanitize_spec(spec, tuple(w.shape), mesh)
    want = tuple(placements(spec, mesh))
    return w if tuple(w.placements) == want else w.redistribute(mesh, want)


def _batch_specs(batch_sds, recipe: ShardingRecipe, cfg) -> Dict:
    dp = recipe.dp

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        leaf = path.split("/")[-1]
        nd = len(tree.shape)
        if leaf in ("tokens", "labels"):
            if nd == 2 and tree.shape[1] > 1 and not cfg.encdec:
                return P(dp, recipe.seq)
            return P(dp, None)
        if leaf == "frames":
            return P(dp, recipe.seq, None)
        if leaf == "image_embeds":
            return P(dp, None, None)
        return P(*([None] * nd))

    out = {}
    for k, v in batch_sds.items():
        if k == "cache":
            out[k] = cache_specs(v, recipe)
        else:
            out[k] = walk(v, k)
    return out


def model_flops_estimate(cfg, spec) -> float:
    n_act = cfg.active_param_count()
    B, S = spec.global_batch, spec.seq_len
    if spec.kind == "train":
        return 6.0 * n_act * B * S
    if spec.kind == "prefill":
        return 2.0 * n_act * B * S
    return 2.0 * n_act * B           # decode: one token per sequence


def cell_sizes(cfg, spec) -> Dict[str, int]:
    """The global byte counts a cell's record carries, from shapes alone:
    ``param_bytes_global``, and ``opt_bytes_global`` (train) or
    ``cache_bytes_global`` (decode)."""
    params = param_shapes(cfg, spec)
    out = {"param_bytes_global": _tree_bytes(params)}
    if spec.kind == "train":
        opt = make_optimizer(cfg.optimizer)
        out["opt_bytes_global"] = _tree_bytes(opt.init(params))
    batch = input_specs(cfg, spec)
    if "cache" in batch:
        out["cache_bytes_global"] = _tree_bytes(batch["cache"])
    return out


def _decode_batch(batch, spec):
    """The port's decode takes ``pos`` as an int: one token against a
    cache of ``seq_len`` positions, all but the last filled."""
    cache = dict(batch["cache"])
    cache["pos"] = spec.seq_len - 1
    return cache, batch["tokens"]


# ------------------------------------------------------------------- cell ---
def lower_cell(arch: str, shape: str, multi_pod: bool = False,
               variant: str = "baseline", mini: bool = False,
               keep_hlo: bool = False) -> Dict:
    """One cell's record.  ``keep_hlo`` is accepted for the reference's
    signature; there is no HLO to keep."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..roofline.trace import StepTrace
    cfg = get_config(arch)
    spec = SHAPES[shape]
    meta = {"arch": arch, "shape": shape, "kind": spec.kind,
            "multi_pod": multi_pod, "variant": variant,
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count(),
            "model_flops": model_flops_estimate(cfg, spec)}
    ok, reason = shape_supported(cfg, shape)
    if not ok:
        return {"meta": meta, "status": "skipped", "reason": reason}

    mesh = (make_mini_mesh(multi_pod=multi_pod) if mini
            else make_production_mesh(multi_pod=multi_pod))
    meta["mesh"] = "x".join(str(s) for s in mesh.shape)
    meta["devices"] = mesh.size()
    recipe = make_recipe(spec.kind, multi_pod)
    cfg, recipe = VARIANTS[variant](cfg, spec, recipe)

    api = build(cfg, attention="plain")
    meta.update(cell_sizes(cfg, spec))
    record: Dict = {"meta": meta, "status": "ok"}
    trace = StepTrace()
    with trace, use_recipe(recipe), implicit_replication():
        train = spec.kind == "train"
        params_sds = param_shapes(cfg, spec, device=FAKE_DEVICE)
        pspecs = param_specs(params_sds, recipe)
        params_in = _shard_sds(params_sds, pspecs, mesh, requires_grad=train)

        batch_sds = input_specs(cfg, spec, device=FAKE_DEVICE)
        bspecs = _batch_specs(batch_sds, recipe, cfg)
        batch_in = _shard_sds(batch_sds, bspecs, mesh)
        args = [params_in, batch_in]

        if train:
            opt = make_optimizer(cfg.optimizer)
            opt_sds = opt.init(params_sds)
            ospecs = opt.state_specs(params_sds, pspecs)
            opt_in = _shard_sds(opt_sds, ospecs, mesh)
            args = [params_in, opt_in, batch_in]
            step = make_train_step(api, opt)
            run = lambda: step(params_in, opt_in, batch_in)   # noqa: E731
        elif spec.kind == "prefill":
            run = lambda: api.prefill(params_in, batch_in, None)  # noqa: E731
        elif variant.startswith("dedup_serving"):
            # The paper's technique as a pod-scale serving feature:
            # DEDUP_NUM_VARIANTS model variants resident as one distinct-
            # block pool + per-variant block maps.  "dedup_serving" uses
            # cfg.dedup_ratio (measured cross-variant distinct fraction);
            # "..._dense_ref" is the no-dedup reference (6 full copies).
            ratio = 1.0 if variant == "dedup_serving_dense_ref" \
                else cfg.dedup_ratio
            pooled_sds, unpool = _pool_params(params_sds, cfg, ratio)
            axes = (("pod", "data", "model") if multi_pod
                    else ("data", "model"))
            # "_sharded": the remapped block maps partition with the pool
            # instead of replicating.
            map_spec = P(axes) if variant.endswith("_sharded") else P()
            pspecs2 = {}
            for k, s in pooled_sds.items():
                if k.endswith("#pool"):
                    pspecs2[k] = P(axes, None, None)
                elif k.endswith("#map"):
                    pspecs2[k] = map_spec
                else:
                    pspecs2[k] = param_spec(k, s.dim(), recipe)
            params_in = _shard_sds(pooled_sds, pspecs2, mesh)
            args = [params_in, batch_in]
            meta["param_bytes_global"] = _tree_bytes(pooled_sds)
            meta["dedup_ratio"] = ratio
            meta["dedup_variants"] = DEDUP_NUM_VARIANTS

            def run():
                cache, tokens = _decode_batch(batch_in, spec)
                params = tree_map(
                    lambda w, s: _relayout(w, s, mesh), unpool(params_in),
                    pspecs)
                return api.decode(params, cache, tokens)
        else:
            serve = make_serve_step(api)

            def run():
                cache, tokens = _decode_batch(batch_in, spec)
                return serve(params_in, {"cache": cache, "tokens": tokens})

        arg_bytes = _local_bytes(args)
        t0 = time.perf_counter()
        trace.reset()
        trace.counting = True
        out = run()
        trace.counting = False
        record["lower_seconds"] = time.perf_counter() - t0
        record["compile_seconds"] = 0.0
        record["memory_analysis"] = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": _local_bytes(out),
            "temp_size_in_bytes": None,
        }
        record["flops_by_op"] = dict(sorted(trace.flops_by_op.items()))
        record["cost_analysis"] = {"flops": float(trace.flops),
                                   "bytes accessed":
                                       float(trace.bytes_accessed)}
        record["collectives"] = collective_bytes(trace.collectives)
        record["trace_ops"] = trace.ops
        del out
    record["hlo_bytes"] = None
    cost = record["cost_analysis"]
    record["roofline"] = roofline_terms(
        cost["flops"], cost["bytes accessed"],
        float(record["collectives"]["weighted_total"]))
    # the trace counts one device's share -> compare against the
    # per-device share of MODEL_FLOPS = 6·N·D (or 2·N·D for inference).
    record["roofline"]["useful_flops_ratio"] = (
        meta["model_flops"] / meta["devices"] / cost["flops"]
        if cost["flops"] else None)
    return record


def cell_path(out_dir: str, arch: str, shape: str, multi_pod: bool,
              variant: str) -> str:
    mesh = "multi" if multi_pod else "single"
    v = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}{v}.json")


def run_cell_and_save(arch, shape, multi_pod, variant, out_dir,
                      mini=False) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    path = cell_path(out_dir, arch, shape, multi_pod, variant)
    try:
        rec = lower_cell(arch, shape, multi_pod, variant, mini=mini)
    except Exception as e:
        rec = {"meta": {"arch": arch, "shape": shape,
                        "multi_pod": multi_pod, "variant": variant},
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--spawn", action="store_true",
                    help="one subprocess per cell (one mesh size a process)")
    ap.add_argument("--mini", action="store_true",
                    help="mini mesh (2x2, or 2x2x2 with --multi-pod)")
    args = ap.parse_args()

    archs = list_archs() if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape in (None, "all")) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    if len({mp for _, _, mp in cells}) > 1 and not args.spawn:
        ap.error("--both-meshes traces two mesh sizes: add --spawn")

    for arch, shape, mp in cells:
        path = cell_path(args.out, arch, shape, mp, args.variant)
        if args.skip_existing and os.path.exists(path):
            print(f"[skip existing] {path}")
            continue
        label = f"{arch} x {shape} ({'multi' if mp else 'single'}-pod, " \
                f"{args.variant})"
        if args.spawn:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape,
                   "--variant", args.variant, "--out", args.out]
            if mp:
                cmd.append("--multi-pod")
            if args.mini:
                cmd.append("--mini")
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True)
            status = "ok" if r.returncode == 0 else "proc-error"
            if r.returncode != 0:
                with open(path, "w") as f:
                    json.dump({"meta": {"arch": arch, "shape": shape,
                                        "multi_pod": mp},
                               "status": "error",
                               "error": r.stderr[-4000:]}, f, indent=1)
            print(f"[{status}] {label} ({time.perf_counter()-t0:.1f}s)")
        else:
            t0 = time.perf_counter()
            rec = run_cell_and_save(arch, shape, mp, args.variant, args.out,
                                    mini=args.mini)
            rl = rec.get("roofline", {})
            print(f"[{rec['status']}] {label} ({time.perf_counter()-t0:.1f}s) "
                  f"dominant={rl.get('dominant')} "
                  f"compute={rl.get('compute_s', 0):.2e}s "
                  f"memory={rl.get('memory_s', 0):.2e}s "
                  f"collective={rl.get('collective_s', 0):.2e}s "
                  + ("" if rec["status"] != "error"
                     else rec.get("error", "")[:200]))


if __name__ == "__main__":
    main()
