"""Counting one rank's share of a step traced on fake tensors.

The dry-run's stand-in for XLA's compiled per-device program: the step
runs on DTensors whose local shards are fake tensors (nothing is
allocated), and :class:`StepTrace`, a ``FakeTensorMode``, sees every op
DTensor runs on a rank's local shard -- the computation one device of
the mesh does, replicated work included -- and every collective a
redistribution issues.  It counts:

* ``flops``: the matrix products' FLOPs (``torch.utils.flop_counter``'s
  formulas on the local shapes: mm, bmm, addmm, baddbmm, convolution,
  attention); elementwise work is not counted;
* ``bytes_accessed``: each op's local input and output bytes, summed op
  by op.  This is an *unfused* count: a chain of elementwise ops that a
  compiler would fuse counts its intermediates, so it is an upper bound
  on HBM traffic, where XLA's ``bytes accessed`` is the fused program's.
  Views, factories without an input (``empty``) and collectives add
  nothing;
* ``collectives``: one ``(kind, result bytes)`` event a collective, kinds
  named as in XLA's HLO (``all-gather``, ``all-reduce``, ...; any other
  collective keeps its op name, which ``collective_bytes`` refuses).

No peak of live temporaries is kept: one taken from when fake tensors
are freed depends on the torch release (weakref finalizers run at other
times), so it is not a property of the step.

DTensor's sharding propagation runs each op once more on the global
shapes to learn the output's metadata; those runs come through the same
mode and are told apart by their caller (``_sharding_prop``) and not
counted.  The models make no strided shard (``sharding.reshape``), whose
offsets DTensor would compute from real index tensors.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_flatten

_COLLECTIVE_KINDS = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"), ("send", "collective-permute"),
    ("recv", "collective-permute"),
)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "device", "detach", "alias", "lift_fresh",
             "wait_tensor", "_local_scalar_dense", "sym_size", "sym_stride",
             "sym_numel", "sym_storage_offset", "is_same_size"}
_PROPAGATION_FILES = ("_sharding_prop.py",)


def _collective_kind(func) -> str:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional", "c10d",
                  "_c10d_functional_autograd"):
        return ""
    name = func._opname
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    # any other collective (a broadcast, a scatter) has no kind in the
    # reference's table: roofline.collective_bytes refuses it
    return "" if name == "wait_tensor" else name


def _called_from(files, depth: int = 40) -> bool:
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code.co_filename.endswith(files):
            return True
        f = f.f_back
        depth -= 1
    return False


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTrace(FakeTensorMode):
    """A ``FakeTensorMode`` that counts the local ops run under it while
    :attr:`counting` is on (see the module docstring)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.counting = False
        self._depth = 0
        self.reset()

    def reset(self) -> None:
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.bytes_accessed = 0
        self.ops = 0
        self.collectives: List[Tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is not NotImplemented and self.counting and self._depth == 0 \
                and not _called_from(_PROPAGATION_FILES):
            self._count(func, args, kwargs or {}, out)
        return out

    # ------------------------------------------------------------- counts --
    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        self.ops += 1
        kind = _collective_kind(func)
        outs = _tensors(out)
        if kind:
            self.collectives.append((kind, sum(_nbytes(t) for t in outs)))
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, out_val=out, **kwargs))
            self.flops += n
            name = str(packet).split(".")[-1]
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        if func._opname in _NO_BYTES or _is_view(func) or \
                any(t.device.type == "meta" for t in outs):
            return
        self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in outs)


def _is_view(func) -> bool:
    """An op whose output aliases an input (``view``, ``transpose``,
    ``expand``, ``t``, ...) moves no bytes."""
    if func.is_view:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and
                              not r.alias_info.is_write for r in rets)
