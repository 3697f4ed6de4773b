"""The port's DTensor paths on a real 4-rank world against their plain
versions.

Four processes (``gloo``, CPU) hold a 2 x 2 ``("data", "model")`` mesh.
Every case draws its inputs from a seed with numpy (the same on every
rank), runs the DTensor path on tensors laid out by the port's specs and
the plain path on the full tensors, and records the largest absolute
difference (every output and gradient, gathered), which must be within
``TOL``.  The cases cover what the dry-run's counts come from:

* split-KV ``decode_attend`` (the cache sharded over its sequence, on one
  mesh dim and on both), with a window and the softcap;
* ``attend`` with heads over ``model``: GQA with the kv heads sharded
  alike, MQA (one kv head gathered and sliced), and a sequence-parallel
  prompt;
* the vocab-parallel ``token_log_likelihood`` and its gradient;
* a reduced deepseek's loss and every parameter's gradient under the
  train recipe (``LowPrecisionDot``'s partial-sum all-reduce, the local
  embedding, the vocab-parallel loss), its prefill under the prefill
  recipe and one decode step under the decode recipe (the cache's
  sequence over ``model``);
* ``moe_block`` expert parallel, equal to the plain block over the whole
  batch: without drops, and with a router that overflows (capacity factor
  0.5), where each rank's slots, gathered, equal the plain ``route``'s
  exactly (the whole batch's capacity and positions), with the tokens
  over ``data`` and over both mesh dims;
* the data-parallel ``mamba_mixer`` and its states.

The four processes run every case once (a module fixture); run as
``python tests/test_torch_dtensor_ranks.py RANK PORT OUT`` it is one
rank of that world.
"""
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WORLD, MESH = 4, (2, 2)
TOL = 1e-5
SEED = 0


# ------------------------------------------------------------- helpers --
def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


def _place(t, spec, mesh):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import placements, sanitize_spec
    spec = sanitize_spec(spec, tuple(t.shape), mesh)
    return distribute_tensor(t, mesh, placements(spec, mesh))


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _err(got, want) -> float:
    from repro_torch.tree import leaves
    gs, ws = leaves(got), leaves(want)
    assert len(gs) == len(ws)
    worst = 0.0
    for g, w in zip(gs, ws):
        if not isinstance(w, torch.Tensor):
            assert g == w, (g, w)
            continue
        g = _full(g)
        assert g.shape == w.shape, (g.shape, w.shape)
        worst = max(worst, float((g.double() - w.double()).abs().max()))
    return worst


def _reduced(arch):
    from repro_torch.configs import get_config, reduced
    return reduced(get_config(arch))


def _model(arch):
    from repro_torch.convert import train_params
    from repro_torch.models import build
    cfg = _reduced(arch)
    api = build(cfg, attention="plain")
    return cfg, api, train_params(api.init(SEED), cfg)


def _placed_params(params, recipe, mesh, grad=False):
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.tree import tree_map

    def f(t, s):
        d = _place(t.detach(), s, mesh)
        return d.requires_grad_() if grad else d
    return tree_map(f, params, param_specs(params, recipe))


# --------------------------------------------------------------- cases --
def _decode(mesh, seq, batch, B, window, softcap, kv_len):
    from repro_torch.distributed.sharding import P
    from repro_torch.models.attention import decode_attend
    rng = np.random.default_rng(SEED)
    q, k, v = (_randn(rng, B, 1, 4, 8), _randn(rng, B, 16, 2, 8),
               _randn(rng, B, 16, 2, 8))
    kw = dict(kv_len=kv_len, window=window, softcap=softcap)
    want = decode_attend(q, k, v, **kw)
    kd, vd = (_place(t, P(batch, seq, None, None), mesh) for t in (k, v))
    assert any(p.is_shard(1) for p in kd.placements)
    got = decode_attend(_place(q, P(batch, None, None, None), mesh), kd, vd,
                        **kw)
    return _err(got, want)


def case_decode_seq_over_model(mesh):
    return _decode(mesh, "model", "data", 2, 0, 0.0, 11)


def case_decode_seq_over_both_window_softcap(mesh):
    return _decode(mesh, ("data", "model"), None, 1, 6, 30.0, 13)


def _backward(out, w, mesh):
    """sum(out * w): w plain, or laid out as the DTensor ``out``."""
    if hasattr(out, "placements"):
        from torch.distributed.tensor import distribute_tensor
        w = distribute_tensor(w, mesh, out.placements)
    (out * w).sum().backward()


def _grads(ts):
    return [t.grad for t in ts]


def _attend(mesh, H, K, q_spec, kv_spec, window):
    """Output and the gradients of q, k, v."""
    from repro_torch.distributed.sharding import P
    from repro_torch.models.attention import attend
    rng = np.random.default_rng(SEED)
    qkv = [_randn(rng, 2, 8, H, 8), _randn(rng, 2, 8, K, 8),
           _randn(rng, 2, 8, K, 8)]
    w = _randn(rng, 2, 8, H, 8)
    plain = [t.clone().requires_grad_() for t in qkv]
    want = attend(*plain, causal=True, window=window)
    _backward(want, w, mesh)
    placed = [_place(t, P(*sp), mesh).requires_grad_()
              for t, sp in zip(qkv, (q_spec, kv_spec, kv_spec))]
    got = attend(*placed, causal=True, window=window)
    _backward(got, w, mesh)
    return max(_err(got, want.detach()), _err(_grads(placed), _grads(plain)))


def case_prefill_gqa_heads_over_model(mesh):
    return _attend(mesh, 4, 2, ("data", None, "model", None),
                   ("data", None, "model", None), 0)


def case_prefill_mqa_kv_gathered_and_sliced(mesh):
    return _attend(mesh, 4, 1, ("data", None, "model", None),
                   ("data", None, None, None), 0)


def case_prefill_sequence_parallel_window(mesh):
    return _attend(mesh, 4, 2, ("data", "model", None, None),
                   ("data", "model", None, None), 5)


def case_log_likelihood_vocab_parallel(mesh):
    from repro_torch.distributed.sharding import P
    from repro_torch.models.layers import token_log_likelihood
    rng = np.random.default_rng(SEED)
    logits = _randn(rng, 4, 6, 32, scale=3.0)
    labels = torch.from_numpy(rng.integers(0, 32, (4, 6)))
    w = _randn(rng, 4, 6)
    x = logits.clone().requires_grad_()
    want = token_log_likelihood(x, labels)
    (want * w).sum().backward()
    xd = _place(logits, P("data", None, "model"), mesh).requires_grad_()
    got = token_log_likelihood(xd, _place(labels, P("data", None), mesh))
    (got * _place(w, P("data", None), mesh)).sum().backward()
    return max(_err(got, want.detach()), _err(xd.grad, x.grad))


def case_loss_and_grads_train_recipe(mesh):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.sharding import (P, make_recipe,
                                                  use_recipe)
    from repro_torch.launch.steps import value_and_grad
    cfg, api, params = _model("deepseek-7b")
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)))
             for k in ("tokens", "labels")}
    loss, grads = value_and_grad(lambda p: api.loss(p, batch), params)
    rec = make_recipe("train")
    with use_recipe(rec), implicit_replication():
        dparams = _placed_params(params, rec, mesh, grad=True)
        dbatch = {k: _place(v, P(("data",), None), mesh)
                  for k, v in batch.items()}
        dloss, dgrads = value_and_grad(lambda p: api.loss(p, dbatch),
                                       dparams)
    return max(_err(dloss, loss), _err(dgrads, grads))


def case_prefill_model_prefill_recipe(mesh):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.sharding import (P, make_recipe,
                                                  use_recipe)
    cfg, api, params = _model("deepseek-7b")
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)))
    with torch.no_grad():
        want = api.prefill(params, {"tokens": tokens}, 16)
        rec = make_recipe("prefill")
        with use_recipe(rec), implicit_replication():
            got = api.prefill(_placed_params(params, rec, mesh),
                              {"tokens": _place(tokens, P(("data",), "model"),
                                                mesh)}, 16)
    return _err(got, want)


def _decode_model(mesh, arch):
    """Logits and the whole cache after a prefill (plain) and one decode
    step (the cache laid out by the decode recipe's specs)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.sharding import (P, cache_specs,
                                                  make_recipe, use_recipe)
    from repro_torch.tree import tree_map
    cfg, api, params = _model(arch)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)))
    step = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1)))
    rec = make_recipe("decode")
    with torch.no_grad():
        _, cache = api.prefill(params, {"tokens": tokens}, 16)
        with use_recipe(rec), implicit_replication():
            dcache = tree_map(
                lambda t, s: _place(t.clone(), s, mesh)
                if isinstance(t, torch.Tensor) else t,
                cache, cache_specs(cache, rec))
            if "k" in dcache["blocks"]:
                assert any(p.is_shard(2)
                           for p in dcache["blocks"]["k"].placements)
            got = api.decode(_placed_params(params, rec, mesh), dcache,
                             _place(step, P(("data",), None), mesh))
        want = api.decode(params, cache, step)
    return _err(got, want)


def case_decode_model_decode_recipe(mesh):
    return _decode_model(mesh, "deepseek-7b")


def case_decode_mamba_model_decode_recipe(mesh):
    return _decode_model(mesh, "mamba2-1.3b")


def _moe(mesh, capacity_factor, x_spec=("data",), dense_ff=0):
    """Output and the gradients of x and every weight; where the router
    overflows, the kept slots are checked too (:func:`_moe_slots`)."""
    import dataclasses
    from repro_torch.distributed.sharding import P, param_spec
    from repro_torch.models.moe import moe_block
    cfg = _reduced("kimi-k2-1t-a32b")
    moe = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor,
                              dense_ff=dense_ff)
    D, E, F = cfg.d_model, moe.num_experts, moe.d_ff
    rng = np.random.default_rng(SEED)
    p = {"router": _randn(rng, D, E, scale=0.5),
         "ew1": _randn(rng, E, D, F, scale=0.2),
         "ew2": _randn(rng, E, F, D, scale=0.2),
         "ew3": _randn(rng, E, D, F, scale=0.2)}
    if dense_ff:
        p.update(dw1=_randn(rng, D, dense_ff, scale=0.2),
                 dw2=_randn(rng, dense_ff, D, scale=0.2),
                 dw3=_randn(rng, D, dense_ff, scale=0.2))
    x = _randn(rng, 4, 6, D)
    w = _randn(rng, 4, 6, D)
    px = {k: v.clone().requires_grad_() for k, v in p.items()}
    xx = x.clone().requires_grad_()
    want = moe_block(xx, px, moe, "silu", True)
    _backward(want, w, mesh)
    pd = {k: _place(v, param_spec(k, v.dim()), mesh).requires_grad_()
          for k, v in p.items()}
    xd = _place(x, P(x_spec, None, None), mesh).requires_grad_()
    if capacity_factor < 1:
        _moe_slots(mesh, moe, x, p["router"], xd)
    got = moe_block(xd, pd, moe, "silu", True)
    _backward(got, w, mesh)
    return max(_err(got, want.detach()), _err(xd.grad, xx.grad),
               _err({k: v.grad for k, v in pd.items()},
                    {k: v.grad for k, v in px.items()}))


def _moe_slots(mesh, moe, x, router, xd):
    """Each rank routes its shard of ``xd`` as ``_moe_dtensor`` does (the
    whole batch's token count, :func:`batch_offsets`); gathered, the
    slots and keeps equal the plain ``route`` of the whole batch exactly,
    and that route drops tokens."""
    from repro_torch.distributed.sharding import (from_local, local,
                                                  parallel_dims,
                                                  shard_placements)
    from repro_torch.models.moe import batch_offsets, route
    B, S, D = x.shape
    T, K = B * S, moe.top_k
    tokens = [m for m, d in enumerate(parallel_dims(xd, {0: (B,)}))
              if d == 0]
    bw = shard_placements([0 if m in tokens else None
                           for m in range(mesh.ndim)])
    with torch.no_grad():
        xl = local(xd.detach(), bw).reshape(-1, D)
        _, slots, keeps, C = route(xl, {"router": router}, moe,
                                   num_tokens=T,
                                   offsets=batch_offsets(mesh, tokens))
        _, want_slots, want_keeps, want_C = route(
            x.reshape(T, D), {"router": router}, moe)
        got_slots = from_local(slots, mesh, bw, (T, K)).full_tensor()
        got_keeps = from_local(keeps, mesh, bw, (T, K)).full_tensor()
    assert C == want_C, (C, want_C)
    assert not bool(want_keeps.all()), "the router must overflow"
    assert torch.equal(got_keeps, want_keeps)
    assert torch.equal(got_slots, want_slots)


def case_moe_expert_parallel_no_drops(mesh):
    return _moe(mesh, 8.0)


def case_moe_expert_parallel_drops_whole_batch_capacity(mesh):
    return _moe(mesh, 0.5)


def case_moe_tokens_over_both_mesh_dims_drops(mesh):
    return _moe(mesh, 0.5, x_spec=("data", "model"))


def case_moe_expert_parallel_dense_ff(mesh):
    return _moe(mesh, 8.0, dense_ff=32)


def case_mamba_mixer_data_parallel(mesh):
    from repro_torch.distributed.sharding import P, param_spec
    from repro_torch.models.transformer import init_params
    from repro_torch.models.ssm import mamba_mixer
    from repro_torch.tree import tree_map
    cfg = _reduced("mamba2-1.3b")
    (name,) = [k for k in init_params(cfg, SEED) if k not in
               ("embed", "head", "final_norm")]
    layer = init_params(cfg, SEED)[name]["mamba"]
    p = tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a[0])),
                 layer)
    rng = np.random.default_rng(SEED)
    x = _randn(rng, 4, 8, cfg.d_model)
    w = _randn(rng, 4, 8, cfg.d_model)
    px = {k: v.clone().requires_grad_() for k, v in p.items()}
    xx = x.clone().requires_grad_()
    want = mamba_mixer(xx, px, cfg.d_model, cfg.ssm)
    _backward(want[0], w, mesh)
    pd = {k: _place(v, param_spec(k, v.dim()), mesh).requires_grad_()
          for k, v in p.items()}
    xd = _place(x, P("data", None, None), mesh).requires_grad_()
    got = mamba_mixer(xd, pd, cfg.d_model, cfg.ssm)
    _backward(got[0], w, mesh)
    return max(_err(got, tree_map(lambda t: t.detach(), want)),
               _err(xd.grad, xx.grad),
               _err({k: v.grad for k, v in pd.items()},
                    {k: v.grad for k, v in px.items()}))


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


# -------------------------------------------------------------- worker --
def _worker(rank: int, port: int, out: str) -> None:
    """One rank: every case on the 2 x 2 mesh; rank 0 writes the results
    (a case that raises records its error on every rank alike)."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    results = {}
    for name, fn in CASES.items():
        try:
            results[name] = fn(mesh)
        except Exception as e:             # recorded, read by the test
            results[name] = f"{type(e).__name__}: {e}"
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results.json")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   str(r), str(port), out], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=240)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert all(p.returncode == 0 for p in procs), "\n".join(
            log[-3000:] for log in logs)
        with open(out) as f:
            return json.load(f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dtensor_path_equals_plain_on_four_ranks(ranks, case):
    err = ranks[case]
    assert isinstance(err, float), err
    assert err <= TOL, f"{case}: max_abs_err={err}"


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
