"""Wrappers of the port's kernels (counterparts of ``repro.kernels.ops``).

A tensor on the CPU goes to the plain PyTorch version in :mod:`.ref`.  A
CUDA tensor launches the hand-written kernel from ``csrc/`` on the
current stream, or raises: when the library did not build, when a launch
fails, or when the inputs are not what the kernel takes.  There is no
fallback from a CUDA tensor to the plain version.

Each kernel keeps a launch count in :data:`LAUNCHES`, raised by one
exactly where the wrapper launches the kernel, so a run can show that its
hot path went through the kernel.  A kernel with two bodies also counts
each body in :data:`VARIANT_LAUNCHES`; which body a call takes is decided
by a pure function (:func:`matmul_plan`, :func:`flash_variant`,
:func:`lsh_variant`, :func:`gather_index_bits`) that the CPU tests reach.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build, ref

__all__ = ["LAUNCHES", "VARIANT_LAUNCHES", "reset_launches", "MatmulPlan",
           "matmul_plan", "flash_variant", "lsh_variant", "gather_index_bits",
           "dedup_matmul", "dedup_embedding",
           "dedup_embedding_striped", "flash_attention", "lsh_signature",
           "ref"]

#: kernel name -> number of launches of its CUDA kernel in this process
LAUNCHES: Dict[str, int] = {name: 0 for name in _build.KERNELS}
#: kernel name -> body -> launches, for the kernels with two bodies:
#: "wgmma" (bf16 tensor cores), "tf32x3" (fp32 products as three tf32
#: ones on the tensor cores), "fma" (fp32 FMAs on CUDA cores); the gather's
#: 32- and 64-bit index instances
VARIANT_LAUNCHES: Dict[str, Dict[str, int]] = {
    "dedup_matmul": {"wgmma": 0, "fma": 0},
    "flash_attention": {"wgmma": 0, "fma": 0},
    "lsh_signature": {"tf32x3": 0, "fma": 0},
    "dedup_embedding": {"idx32": 0, "idx64": 0},
}
_VARIANTS = {"fma": 0, "wgmma": 1, "tf32x3": 1}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: SMs of one H100; split-K aims at two blocks for each
H100_SMS = 132
#: TMA needs 16-byte aligned base addresses and byte strides
TMA_ALIGN = 16


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in VARIANT_LAUNCHES.values():
        for body in counts:
            counts[body] = 0


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _check_index(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: indices must be int32, got {t.dtype}")


def _launched(name: str, err: int, variant: Optional[str] = None) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1
    if variant is not None:
        VARIANT_LAUNCHES[name][variant] += 1


def _check_tma(name: str, tensors, strides) -> None:
    """TMA reads each tensor from a 16-byte aligned base with 16-byte
    aligned byte strides; raise on what it cannot take."""
    for t in tensors:
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name}: a base address is not {TMA_ALIGN}-byte "
                             f"aligned (TMA)")
    for what, nbytes in strides:
        if nbytes % TMA_ALIGN:
            raise ValueError(f"{name}: {what} is {nbytes} bytes, not a "
                             f"multiple of {TMA_ALIGN} (TMA)")


# ------------------------------------------------------------ dedup_matmul --
class MatmulPlan(NamedTuple):
    """How ``dedup_matmul`` runs one call on the card."""
    variant: str                 # "wgmma" or "fma"
    tile: Tuple[int, int]        # output rows x columns a block
    grid: Tuple[int, int, int]   # (M tiles, N tiles, splits)
    per_split: int               # storage row-blocks a split sums
    workspace: Optional[Tuple[int, int, int]]   # fp32 [splits, M, N]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def matmul_plan(M: int, nkb: int, nnb: int, bk: int, bn: int,
                dtype: torch.dtype) -> MatmulPlan:
    """The body, tiles and K split of one ``dedup_matmul`` call.

    bf16 with a storage depth ``bk`` that is a multiple of 16 (wgmma's k)
    takes the tensor-core body, 64 x 32 output tiles; fp32, and bf16 at
    other depths, the CUDA-core body, 32 x 64 tiles (a tile never crosses
    a storage-block column).  K is split along the storage row-blocks into
    runs of equal length, as few as give the grid 2 x 132 blocks where
    ``nkb`` allows; more than one split sums through an fp32 workspace."""
    wgmma = dtype == torch.bfloat16 and bk % 16 == 0
    tm, tn = (64, 32) if wgmma else (32, 64)
    tiles_m = -(-M // tm)
    tiles_n = nnb * -(-bn // tn)
    want = -(-2 * H100_SMS // max(1, tiles_m * tiles_n))
    # the longest run of storage blocks that still gives ``want`` splits
    per = max([p for p in range(1, nkb + 1) if -(-nkb // p) >= want],
              default=1)
    splits = -(-nkb // per)
    per = -(-nkb // splits)                    # even runs, none empty
    return MatmulPlan("wgmma" if wgmma else "fma", (tm, tn),
                      (tiles_m, tiles_n, splits), per,
                      (splits, M, nnb * bn) if splits > 1 else None)


def dedup_matmul(x, pool, block_map, out_dtype=None):
    """x [..., K] @ W_virtual -> [..., N].

    pool [n_distinct, bk, bn]; block_map [K/bk, N/bn] int32.  On CUDA the
    kernel masks a ragged M itself (no padding pass); x, pool and the
    output share one dtype (float32 or bfloat16), and TMA needs x and
    pool 16-byte aligned with ``bk`` and ``bn`` rows of whole 16-byte
    units.  The body and the K split come from :func:`matmul_plan`; the
    result is the same bits from call to call."""
    if x.device.type == "cpu":
        return ref.dedup_matmul(x, pool, block_map, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dedup_matmul: no kernel for {x.device}")
    nkb, nnb = block_map.shape
    _, bk, bn = pool.shape
    if x.shape[-1] != nkb * bk:
        raise ValueError(f"dedup_matmul: x has K={x.shape[-1]}, "
                         f"the block map covers {nkb * bk}")
    if x.dtype not in _DTYPES or pool.dtype != x.dtype:
        raise ValueError(f"dedup_matmul: x {x.dtype} / pool {pool.dtype}; "
                         "the kernel takes float32 or bfloat16 for both")
    if (out_dtype or x.dtype) != x.dtype:
        raise ValueError("dedup_matmul: the kernel writes x's dtype")
    _check_index("dedup_matmul", block_map)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    _check_cuda("dedup_matmul", x2, pool, block_map)
    M = x2.shape[0]
    out = torch.empty((M, nnb * bn), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(lead + (nnb * bn,))
    es = x.element_size()
    _check_tma("dedup_matmul", (x2, pool),
               (("a storage block's row of x (bk)", bk * es),
                ("a row of x (K)", nkb * bk * es),
                ("a row of a storage block (bn)", bn * es)))
    plan = matmul_plan(M, nkb, nnb, bk, bn, x.dtype)
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
          if plan.workspace else None)
    fn = _build.load("dedup_matmul")
    with torch.cuda.device(x.device):
        err = fn(x2.data_ptr(), pool.data_ptr(), block_map.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 M, pool.shape[0], nkb, nnb, bk, bn, _DTYPES[x.dtype],
                 _VARIANTS[plan.variant], plan.grid[2], _stream(x.device))
    _launched("dedup_matmul", err, plan.variant)
    return out.reshape(lead + (nnb * bn,))


# --------------------------------------------------------- dedup_embedding --
def gather_index_bits(pool_numel: int, out_numel: int) -> int:
    """The width of the gather kernel's offsets: 32 when the slab and the
    output both hold fewer than 2**31 elements, else 64."""
    return 32 if max(pool_numel, out_numel) < 2 ** 31 else 64


def dedup_embedding_striped(ids, pool, block_map, width=None):
    """Rows of a 2-D virtual tensor stored as ``(bh, bw)`` blocks.

    ids [B] int32; pool [n_blocks, bh, bw]; block_map [gh, gw] int32.
    Returns [B, width or gw*bw].  On CUDA every column stripe is gathered
    in ONE launch (the reference launches once per stripe and
    concatenates), one warp an output row, with 32- or 64-bit offsets
    (:func:`gather_index_bits`); the result is bit-equal to :func:`ref.
    dedup_embedding_striped`."""
    gh, gw = block_map.shape
    n, bh, bw = pool.shape
    width = gw * bw if width is None else int(width)
    if ids.device.type == "cpu":
        return ref.dedup_embedding_striped(ids, pool, block_map, width)
    if ids.device.type != "cuda":
        raise ValueError(f"dedup_embedding: no kernel for {ids.device}")
    if not 0 < width <= gw * bw:
        raise ValueError(f"dedup_embedding: width {width} outside "
                         f"(0, {gw * bw}]")
    _check_index("dedup_embedding", ids)
    _check_index("dedup_embedding", block_map)
    _check_cuda("dedup_embedding", ids, pool, block_map)
    B = ids.shape[0]
    out = torch.empty((B, width), dtype=pool.dtype, device=pool.device)
    if B == 0:
        return out
    bits = gather_index_bits(pool.numel(), out.numel())
    fn = _build.load("dedup_embedding")
    with torch.cuda.device(ids.device):
        err = fn(pool.data_ptr(), ids.data_ptr(), block_map.data_ptr(),
                 out.data_ptr(), B, n, bh, bw, gw, width, pool.element_size(),
                 bits, _stream(ids.device))
    _launched("dedup_embedding", err, f"idx{bits}")
    return out


def dedup_embedding(ids, pool, row_block_map):
    """ids [...] -> [..., D] rows of the virtual embedding.

    pool [n_distinct, bv, D]; row_block_map [V/bv] int32: the striped
    gather with one stripe of width D."""
    lead = ids.shape
    out = dedup_embedding_striped(ids.reshape(-1), pool,
                                  row_block_map.reshape(-1, 1))
    return out.reshape(lead + (out.shape[-1],))


# --------------------------------------------------------- flash_attention --
def flash_variant(dtype: torch.dtype, hd: int) -> str:
    """The body of ``flash_attention`` for a dtype and head dim: "wgmma"
    (bf16 tensor cores, TMA) for bf16 with hd a multiple of 16 in
    [64, 256]; "fma" (fp32 FMAs on CUDA cores) for fp32 and the other
    bf16 head dims."""
    if dtype == torch.bfloat16 and hd % 16 == 0 and 64 <= hd <= 256:
        return "wgmma"
    return "fma"


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, out_dtype=None):
    """q [B, Sq, H, hd]; k, v [B, Skv, K, hd] (GQA, H % K == 0) ->
    [B, Sq, H, hd] in ``out_dtype`` (default q's dtype).

    On CUDA the kernel masks ragged Sq and Skv itself (no padding pass)
    and takes float32 or bfloat16 for all three inputs, hd <= 256; the
    body comes from :func:`flash_variant`.  Either body writes its fp32
    result as float32 or bfloat16 (``out_dtype``), rounding it at most
    once.  It skips key tiles the mask hides entirely unless the call can
    produce a row with no visible key, which then keeps the plain
    version's mean of v."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Kh == 0 or H % Kh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if not 0 < hd <= 256 or Skv == 0:
        raise ValueError(f"flash_attention: hd={hd}, Skv={Skv}; the kernel "
                         "takes 0 < hd <= 256 and Skv > 0")
    if q.dtype not in _DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q {q.dtype}, k {k.dtype}, v "
                         f"{v.dtype}; the kernel takes one dtype, float32 "
                         "or bfloat16")
    out_dtype = out_dtype or q.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"flash_attention: out_dtype {out_dtype}; the "
                         "kernel writes float32 or bfloat16")
    _check_cuda("flash_attention", q, k, v)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    scale = hd ** -0.5 if scale is None else float(scale)
    variant = flash_variant(q.dtype, hd)
    if variant == "wgmma":
        _check_tma("flash_attention", (q, k, v, out), ())
    # a row with no visible key exists only if some query sits a whole
    # window past the last key; only then must every tile be visited
    skip = not (window and Sq >= Skv + window)
    fn = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, H, Kh, hd, int(bool(causal)), int(window),
                 float(softcap), scale, int(skip), _DTYPES[q.dtype],
                 _DTYPES[out_dtype], _VARIANTS[variant], _stream(q.device))
    _launched("flash_attention", err, variant)
    return out


# ----------------------------------------------------------- lsh_signature --
def lsh_variant(n: int, dim: int, nh: int) -> str:
    """The body of ``lsh_signature`` for blocks [n, dim] and nh hashes:
    "tf32x3" (three tf32 products on the tensor cores, TMA) where TMA can
    stride x and the workspace (dim % 4 == 0) and the epilogue can store
    the hashes in int32 pairs (nh % 2 == 0); the body walks 64-hash tiles
    and TMA zero-fills the last one, so nh is otherwise free.  "fma"
    (IEEE fp32 FMAs on CUDA cores) otherwise."""
    if dim % 4 == 0 and nh % 2 == 0 and nh > 0:
        return "tf32x3"
    return "fma"


def lsh_signature(blocks, proj, bias, r: float):
    """blocks [n, dim] @ proj [dim, nh] + bias [nh], divided by r and
    floored -> int32 [n, nh]: the L2-LSH signatures of the index build.

    On CUDA all three inputs are contiguous float32 on one device; the
    body comes from :func:`lsh_variant`.  "tf32x3" splits x and proj into
    tf32 halves and sums three tensor-core products (about 2**-22 of each
    term is dropped) through an fp32 workspace [2, nh, dim] allocated
    here; TMA reads blocks, so it raises on a base address that is not
    16-byte aligned.  "fma" sums in IEEE fp32.  Both add the bias and
    divide by r rounded to fp32, as numpy does, and take ragged n, dim
    and nh.  The result may differ from the plain version only at a
    bucket edge (:func:`ref.lsh_edges`)."""
    if blocks.device.type == "cpu":
        return ref.lsh_signature(blocks, proj, bias, r)
    if blocks.device.type != "cuda":
        raise ValueError(f"lsh_signature: no kernel for {blocks.device}")
    if blocks.dim() != 2 or proj.dim() != 2 or bias.dim() != 1 \
            or proj.shape[0] != blocks.shape[1] \
            or bias.shape[0] != proj.shape[1]:
        raise ValueError(f"lsh_signature: blocks {tuple(blocks.shape)}, "
                         f"proj {tuple(proj.shape)}, bias "
                         f"{tuple(bias.shape)}")
    for t in (blocks, proj, bias):
        if t.dtype != torch.float32:
            raise ValueError(f"lsh_signature: the kernel takes float32, "
                             f"got {t.dtype}")
    _check_cuda("lsh_signature", blocks, proj, bias)
    n, dim = blocks.shape
    nh = proj.shape[1]
    out = torch.empty((n, nh), dtype=torch.int32, device=blocks.device)
    if n == 0 or nh == 0:
        return out
    variant = lsh_variant(n, dim, nh)
    ws = None
    if variant == "tf32x3":
        _check_tma("lsh_signature", (blocks,), (("a row of blocks", dim * 4),))
        ws = torch.empty((2, nh, dim), dtype=torch.float32,
                         device=blocks.device)
    fn = _build.load("lsh_signature")
    with torch.cuda.device(blocks.device):
        err = fn(blocks.data_ptr(), proj.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 n, dim, nh, float(r), _VARIANTS[variant],
                 _stream(blocks.device))
    _launched("lsh_signature", err, variant)
    return out
