"""Sharding recipes: DP / FSDP / TP / EP / SP over the production mesh.

Counterpart of ``repro.distributed.sharding``, with its recipes, site
names and parameter rules.  Axes (``launch.mesh``): single-pod
``("data", "model")`` = (16, 16); multi-pod ``("pod", "data", "model")``
= (2, 16, 16).

* params: 2D-sharded -- FSDP over ``data``, TP over ``model``.
* MoE experts: EP over ``model``; expert-internal dims FSDP over ``data``.
* activations: batch over (``pod``, ``data``); optional sequence parallel
  (``seq`` axis) for long prefill; logits vocab over ``model``.

A spec is the port's own :class:`PartitionSpec`, a tuple that compares
equal to the reference's entry by entry: one entry a tensor dim, each a
mesh axis name, a tuple of names or None.  :func:`placements` turns it
into DTensor placements on a ``DeviceMesh``: ``Shard(dim)`` on every
mesh dim an entry names, ``Replicate()`` on the others; a tuple entry
shards one tensor dim over several mesh dims, which must come in mesh
order (DTensor's default sharding order).

Models call :func:`hint` with a *site name*; the active
:class:`ShardingRecipe` (a contextvar set by the launcher) maps sites to
specs, and a DTensor activation is redistributed to the site's spec.
Outside a recipe, or on a plain tensor, hints are the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("recipe", default=None)


def _norm_entry(p):
    if isinstance(p, (tuple, list)):
        p = tuple(p)
        return None if not p else p[0] if len(p) == 1 else p
    return p


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: the reference's ``jax.sharding.
    PartitionSpec`` as a plain tuple (``P(None, "data") == (None,
    "data")``), its entries normalized as JAX's are: a one-name tuple is
    the name, an empty one None."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_norm_entry(p) for p in parts))

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRecipe:
    """Axis assignment for one run mode (train / prefill / decode)."""
    dp: Tuple[str, ...] = ("data",)       # batch ("pod","data") when multi-pod
    tp: Optional[str] = "model"           # tensor/expert parallel axis
    fsdp: Optional[str] = "data"          # param FSDP axis
    seq: Optional[str] = None             # sequence-parallel axis (prefill)
    kv_seq: Optional[str] = None          # decode KV-cache sequence axis
    sites: Dict[str, P] = dataclasses.field(default_factory=dict)

    def site(self, name: str) -> Optional[P]:
        return self.sites.get(name)


def make_recipe(mode: str, multi_pod: bool = False,
                overrides: Optional[Dict[str, P]] = None) -> ShardingRecipe:
    dp = ("pod", "data") if multi_pod else ("data",)
    tp, fsdp = "model", "data"
    if mode == "train":
        sites = {
            "residual": P(dp, None, None),
            "act_ff":   P(dp, None, tp),
            "logits":   P(dp, None, tp),
            "moe_disp": P(tp, None, None),      # [E, C, D] expert-sharded
        }
        rec = ShardingRecipe(dp, tp, fsdp, None, None, sites)
    elif mode == "prefill":
        # Sequence parallel: the prompt split over `model`, batch over dp.
        # The attn_q / attn_kv / attn_o sites stay available, unset.
        sites = {
            "residual": P(dp, tp, None),
            "act_ff":   P(dp, tp, None),
            "logits":   P(dp, None, tp),      # [B, 1, V]: vocab over TP
            "moe_disp": P(tp, None, None),
        }
        rec = ShardingRecipe(dp, tp, fsdp, tp, None, sites)
    elif mode == "decode":
        # One token per step: KV cache sequence sharded over `model`.
        sites = {
            "residual": P(dp, None, None),
            "act_ff":   P(dp, None, tp),
            "logits":   P(dp, None, tp),
            "moe_disp": P(tp, None, None),
        }
        rec = ShardingRecipe(dp, tp, fsdp, None, tp, sites)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if overrides:
        sites = dict(rec.sites)
        sites.update(overrides)
        rec = dataclasses.replace(rec, sites=sites)
    return rec


@contextlib.contextmanager
def use_recipe(recipe: Optional[ShardingRecipe]):
    tok = _ACTIVE.set(recipe)
    try:
        yield recipe
    finally:
        _ACTIVE.reset(tok)


def current_recipe() -> Optional[ShardingRecipe]:
    return _ACTIVE.get()


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def hint(x, site: str):
    """The reference's ``with_sharding_constraint`` at a named activation
    site: a DTensor ``x`` is redistributed to the active recipe's spec
    for ``site`` (fitted to its rank and sanitized for its shape); a plain
    tensor, or no recipe, or an unset site, returns ``x`` itself."""
    rec = _ACTIVE.get()
    if rec is None:
        return x
    spec = rec.site(site)
    if spec is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    spec = sanitize_spec(_fit_rank(spec, x.ndim), tuple(x.shape), mesh)
    want = tuple(placements(spec, mesh))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def reshape(x, *shape):
    """``x.reshape(*shape)``, for a DTensor without the views DTensor
    cannot make alike in every torch release: a merge of dims keeps the
    sharding of its first dim only, and a split of a sharded dim keeps it
    only where the new leading dim divides over its mesh dims (8 kv heads
    over a ``model`` axis of 16 do not).  The mesh dims of any other
    sharding of the reshaped dims are replicated first (an all-gather,
    where XLA would reshard)."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    old = tuple(x.shape)
    new = _resolve_shape(old, shape)
    sizes = tuple(x.device_mesh.shape)
    bad = set()                        # input dims whose sharding must go
    for ins, outs in _view_groups(old, new):
        ins = [d for d in ins if old[d] != 1]
        outs = [d for d in outs if new[d] != 1]
        if len(ins) <= 1 and len(outs) <= 1:
            continue
        sharded = [m for m, p in enumerate(x.placements)
                   if isinstance(p, Shard) and p.dim in ins]
        if len(ins) > 1 and len(outs) == 1:          # a merge
            bad |= {d for d in ins[1:]}
        elif len(ins) == 1:                          # a split
            n = math.prod(sizes[m] for m in sharded)
            if new[outs[0]] % n:
                bad.add(ins[0])
        else:
            bad |= set(ins)
    want = [Replicate() if isinstance(p, Shard) and p.dim in bad else p
            for p in x.placements]
    if want != list(x.placements):
        x = x.redistribute(x.device_mesh, want)
    return _Reshape.apply(x, new)


class _Reshape(torch.autograd.Function):
    """The view, whose backward reshapes the gradient by the same rule
    (the gradient may arrive sharded where the input was not)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return reshape(g, *ctx.shape), None


def _view_groups(old, new):
    """Pairs (old dims, new dims) of a reshape, each pair one block of
    equal element count (size-1 dims join the block they sit in)."""
    groups, i, j = [], 0, 0
    while i < len(old) or j < len(new):
        ins, outs = [i] if i < len(old) else [], [j] if j < len(new) else []
        a = old[i] if i < len(old) else 1
        b = new[j] if j < len(new) else 1
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                ins.append(i)
                a *= old[i]
                i += 1
            else:
                outs.append(j)
                b *= new[j]
                j += 1
        groups.append((ins, outs))
    return groups


def _resolve_shape(old, shape) -> Tuple[int, ...]:
    """``shape`` with its -1 resolved against ``old``'s element count."""
    shape = tuple(shape[0]) if len(shape) == 1 and \
        isinstance(shape[0], (tuple, list)) else tuple(shape)
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        shape = tuple(math.prod(old) // known if d == -1 else d
                      for d in shape)
    return shape


# ------------------------------------------- local computation on DTensors --
# The model's DTensor forms (attention, embedding, loss, MoE, SSM mixer)
# each redistribute their operands, run the plain function on this rank's
# shard and combine; the layout choices they share live here.

def parallel_dims(x, dims_sizes) -> List[Optional[int]]:
    """For each mesh dim of DTensor ``x``, the tensor dim it may keep
    sharding: one of ``dims_sizes`` ({dim: (sizes that must divide)})
    that ``x`` is sharded on there, while the product of the mesh dims
    kept on one tensor dim divides every size listed for it; else None
    (gathered)."""
    kept: Dict[int, int] = {}
    out: List[Optional[int]] = []
    for p, n in zip(x.placements, x.device_mesh.shape):
        d = p.dim if isinstance(p, Shard) else None
        if n > 1 and d in dims_sizes and all(
                size % (kept.get(d, 1) * n) == 0 for size in dims_sizes[d]):
            kept[d] = kept.get(d, 1) * n
            out.append(d)
        else:
            out.append(None)
    return out


def shard_placements(dims) -> List:
    """``Shard(d)`` for each mesh dim whose entry ``d`` is not None, else
    ``Replicate()``."""
    return [Replicate() if d is None else Shard(d) for d in dims]


def shard_range(x, dim: int, placements=None) -> Tuple[int, int]:
    """(first index, length) of this rank's shard of DTensor ``x`` along
    ``dim``, laid out by ``placements`` (its own by default): the dim
    chunked over the mesh dims that shard it, in mesh order (evenly: see
    :func:`sanitize_spec`)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    start, size = 0, x.shape[dim]
    for m, (p, n) in enumerate(zip(placements or x.placements,
                                   mesh.shape)):
        if isinstance(p, Shard) and p.dim == dim:
            size //= n
            start += coord[m] * size
    return start, size


def local(x, want, partial=()):
    """This rank's shard of DTensor ``x`` laid out by ``want``.  Its
    gradient comes back as partial sums over the mesh dims in
    ``partial``: those where ``want`` replicates ``x`` but each rank
    uses its copy differently (other tokens, another slice)."""
    x = x.redistribute(x.device_mesh, want)
    return x.to_local(grad_placements=[
        Partial() if m in partial else p for m, p in enumerate(want)])


class _AllReduce(torch.autograd.Function):
    """All-reduce over process groups; the backward is the identity: what
    follows is computed alike on every rank of the groups."""

    @staticmethod
    def forward(ctx, t, op, groups):
        import torch.distributed._functional_collectives as funcol
        for g in groups:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce(t, mesh, dims, op: str = "sum"):
    """``t`` (this rank's plain tensor) reduced over the mesh dims
    ``dims``, with an identity backward (see :class:`_AllReduce`; a "max"
    is for values that need no gradient)."""
    groups = [mesh.get_group(m) for m in dims]
    return _AllReduce.apply(t, op, groups) if groups else t


class _ReduceGrad(torch.autograd.Function):
    """The identity, whose backward all-reduces the gradient (sum) over
    process groups: for an input each rank of the groups uses on its own
    part of the work."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, "sum", ctx.groups), None


def all_reduce_grad(t, mesh, dims):
    """``t`` itself, whose gradient is summed over the mesh dims ``dims``
    (see :class:`_ReduceGrad`)."""
    groups = [mesh.get_group(m) for m in dims]
    return _ReduceGrad.apply(t, groups) if groups else t


def write_seq(dst, src, pos: int, dim: int = 1) -> None:
    """``dst[..., pos:pos + n, ...] = src`` along ``dim``, in place (a
    cache write).  A DTensor ``dst`` sharded over ``dim`` is written
    where it lives: each rank copies the positions it holds (DTensor's
    own slice of a sharded dim would gather it and write the copy)."""
    n = src.shape[dim]
    if not is_dtensor(dst):
        dst[(slice(None),) * dim + (slice(pos, pos + n),)] = src
        return
    mesh = dst.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in dst.placements]
    s = src.redistribute(mesh, want).to_local()
    start, size = shard_range(dst, dim)
    lo, hi = max(pos, start), min(pos + n, start + size)
    if lo < hi:
        dst.to_local()[(slice(None),) * dim + (slice(lo - start,
                                                     hi - start),)] = \
            s[(slice(None),) * dim + (slice(lo - pos, hi - pos),)]


def from_local(t, mesh, placements, shape):
    """The DTensor of global ``shape`` (contiguous) whose shard on this
    rank is ``t``, laid out by ``placements``."""
    shape = tuple(shape)
    return DTensor.from_local(t.contiguous(), mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _fit_rank(spec: P, ndim: int) -> P:
    parts = list(spec)
    if len(parts) < ndim:
        parts = parts + [None] * (ndim - len(parts))
    elif len(parts) > ndim:
        # Drop *inner* Nones first, else truncate (decode: [B,1,D] vs [B,S,D]).
        parts = [p for p in parts if p is not None]
        parts = parts + [None] * (ndim - len(parts)) if len(parts) < ndim \
            else parts[:ndim]
    return P(*parts)


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``) or of
    anything whose ``shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def sanitize_spec(spec: P, shape, mesh) -> P:
    """Drop mesh axes that do not evenly divide the corresponding dim
    (an uneven shard cannot be viewed or flattened; e.g. batch=1 decode
    cells and odd vocabs fall back to replication on that dim)."""
    sizes = _axis_sizes(mesh)
    parts = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            parts.append(None)
            continue
        axes = list(ax) if isinstance(ax, tuple) else [ax]
        while axes and dim % math.prod(sizes[a] for a in axes) != 0:
            axes = axes[:-1]
        if not axes:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(tuple(axes))
    return P(*parts)


_LIB = None


def _register_mm_dtype() -> None:
    """Make ``aten.mm.dtype`` (``torch.mm(a, b, out_dtype=F32)``, the
    port's bf16 product with an fp32 result, :class:`models.layers.
    LowPrecisionDot`) run on DTensors on every device, so a DTensor
    product takes one op (and moves its operands in their own dtype)
    wherever it runs.  Two pieces, each only where torch lacks it:

    * a DTensor sharding strategy: ``aten.mm.default``'s, on the two
      operands.  The local op is still ``mm.dtype``, so the rounding is
      the one without a mesh;
    * a CPU kernel (the card has cuBLAS's): both operands widened to
      ``out_dtype``, then one product.  bf16 products are exact in fp32,
      so it is the same math as the plain tensors' route.

    Run once, when this module is imported."""
    global _LIB
    from torch.distributed.tensor._op_schema import (OpSchema,
                                                     RuntimeSchemaInfo)
    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    if aten.mm.dtype not in prop.op_strategy_funcs:
        mm = prop.op_strategy_funcs[aten.mm.default]

        def mm_dtype(op_schema):
            return mm(OpSchema(aten.mm.default, op_schema.args_schema[:2],
                               {}))

        prop.register_op_strategy(aten.mm.dtype, mm_dtype,
                                  RuntimeSchemaInfo(static_argnum=2))
    if not torch._C._dispatch_has_kernel_for_dispatch_key("aten::mm.dtype",
                                                          "CPU"):
        _LIB = torch.library.Library("aten", "IMPL")
        _LIB.impl("mm.dtype", lambda a, b, out_dtype: torch.mm(
            a.to(out_dtype), b.to(out_dtype)), "CPU")


_register_mm_dtype()


def placements(spec: P, mesh) -> List:
    """DTensor placements of ``spec`` on ``mesh`` (one a mesh dim):
    ``Shard(i)`` where entry ``i`` names the mesh dim's axis, alone or in
    a tuple, else ``Replicate()``.  A tuple's axes must be in mesh order,
    the order DTensor shards one tensor dim over several mesh dims."""
    names = list(mesh.mesh_dim_names)
    out: List = [Replicate() for _ in names]
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        axes = list(ax) if isinstance(ax, tuple) else [ax]
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"placements: {ax!r} is not in the mesh's "
                             f"order {tuple(names)}")
        for m in dims:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"placements: mesh axis {names[m]!r} "
                                 f"shards two dims of {spec}")
            out[m] = Shard(i)
    return out


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor laid out by
    ``spec`` (which divides it evenly: see :func:`sanitize_spec`)."""
    sizes = _axis_sizes(mesh)
    out = list(shape)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = math.prod(sizes[a] for a in axes)
        if out[i] % n:
            raise ValueError(f"local_shape: dim {i} of {tuple(shape)} does "
                             f"not divide over {axes}")
        out[i] //= n
    return tuple(out)


# ------------------------------------------------------------- param rules --
# leaf name -> spec builder(recipe, ndim).  All per-layer params carry a
# leading stacked-layer axis (never sharded).
def _mat(in_ax, out_ax):
    def rule(rec: ShardingRecipe, ndim: int) -> P:
        base = [in_ax(rec), out_ax(rec)]
        return P(*([None] * (ndim - 2) + base))
    return rule


_FSDP = lambda r: r.fsdp      # noqa: E731
_TP = lambda r: r.tp          # noqa: E731
_NONE = lambda r: None        # noqa: E731

_PARAM_RULES = {
    # attention (cross-attn c* shares rules)
    r"^(wq|wk|wv|cq|ck|cv)$": _mat(_FSDP, _TP),
    r"^(wo|co)$":             _mat(_TP, _FSDP),
    r"^(bq|bk|bv)$":          lambda rec, nd: P(*([None] * (nd - 1) + [rec.tp])),
    # dense mlp + arctic dense-residual
    r"^(w1|w3|dw1|dw3)$":     _mat(_FSDP, _TP),
    r"^(w2|dw2)$":            _mat(_TP, _FSDP),
    # MoE: experts over TP(=EP) axis, d_model over FSDP
    r"^(ew1|ew3)$": lambda rec, nd: P(*([None] * (nd - 3) + [rec.tp, rec.fsdp, None])),
    r"^ew2$":       lambda rec, nd: P(*([None] * (nd - 3) + [rec.tp, None, rec.fsdp])),
    r"^router$":    _mat(_FSDP, _NONE),
    # mamba
    r"^in_proj$":   _mat(_FSDP, _TP),
    r"^out_proj$":  _mat(_TP, _FSDP),
    r"^(conv_w|conv_b|A_log|Dp|dt_bias)$":
        lambda rec, nd: P(*([None] * (nd - 1) + [rec.tp])),
    # embeddings
    r"^embed$":     lambda rec, nd: P(rec.tp, rec.fsdp),
    r"^head$":      lambda rec, nd: P(rec.fsdp, rec.tp),
    r"^pos_embed$": lambda rec, nd: P(*([None] * nd)),
}


def param_spec(path: str, ndim: int,
               recipe: Optional[ShardingRecipe] = None) -> P:
    rec = recipe or current_recipe() or make_recipe("train")
    leaf = path.split("/")[-1]
    for pat, rule in _PARAM_RULES.items():
        if re.match(pat, leaf):
            return rule(rec, ndim)
    return P()      # norms, scalars: replicated


def param_specs(params, recipe: Optional[ShardingRecipe] = None):
    """Tree of specs matching a params tree of tensors (by key path)."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        return param_spec(prefix, len(tree.shape), recipe)
    return walk(params, "")


POOL_SHARD_AXIS = "shard"


def slab_spec(ndim: int = 5) -> P:
    """Spec of a stacked per-shard page slab ``[num_shards, capacity,
    blocks_per_page, bh, bw]``: the shard dimension partitions over the
    serving mesh's ``shard`` axis, block payloads replicate.  (The
    dry-run ``dedup_serving*`` variants shard the flat pool the same way
    over the production axes.)"""
    return P(*([POOL_SHARD_AXIS] + [None] * (ndim - 1)))


def slab_sharding(mesh, shape) -> List:
    """Placements of a stacked slab of ``shape`` on a ``("shard",)``
    serving mesh (``launch.mesh.make_shard_mesh``); replication on dims
    the mesh cannot evenly partition.  The reference returns a
    ``NamedSharding``; the port's counterpart is the placements list."""
    return placements(sanitize_spec(slab_spec(len(shape)), shape, mesh),
                      mesh)


def cache_specs(cache, recipe: ShardingRecipe):
    """Specs for a decode cache tree (leaf-name keyed)."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        leaf = prefix.split("/")[-1]
        if leaf == "pos":               # a tensor or the port's int
            return P()
        nd = len(tree.shape)
        if leaf in ("k", "v"):          # [L, B, S, K, hd]
            return P(None, recipe.dp, recipe.kv_seq, None, None)
        if leaf == "ssm_state":         # [L, B, H, hd, state]
            return P(None, recipe.dp, recipe.tp, None, None)
        if leaf == "conv_state":        # [L, B, K-1, C]
            return P(None, recipe.dp, None, recipe.tp)
        if leaf in ("enc_k", "enc_v"):  # [L, B, S_enc, K, hd]
            return P(None, recipe.dp, recipe.kv_seq, None, None)
        return P(*([None] * nd))
    return walk(cache, "")


def shard_cache(cache, like):
    """A prefill's fresh cache for a DTensor forward: zeros of each leaf's
    shape and dtype as DTensors on ``like``'s mesh, laid out by the
    active recipe's :func:`cache_specs` (sanitized).  ``cache`` itself
    when ``like`` is a plain tensor or no recipe is active."""
    rec = _ACTIVE.get()
    if rec is None or not is_dtensor(like):
        return cache
    from torch.distributed.tensor import zeros
    mesh = like.device_mesh

    def walk(t, spec):
        if isinstance(t, dict):
            return {k: walk(v, spec[k]) for k, v in t.items()}
        if not isinstance(t, torch.Tensor):
            return t                       # the port's int ``pos``
        spec = sanitize_spec(spec, tuple(t.shape), mesh)
        return zeros(tuple(t.shape), dtype=t.dtype, device_mesh=mesh,
                     placements=placements(spec, mesh))
    return walk(cache, cache_specs(cache, rec))
