#!/usr/bin/env python3
"""Where the time of one ``flash_attention`` launch goes, CTA by CTA.

    python3 scripts/flash_trace.py

Run from the root of a checkout on a machine with an H100 and ``nvcc``.
It builds a copy of ``csrc/flash_attention.cu`` whose tensor-core body
stamps ``%globaltimer`` (thread 0 of each CTA) at the start, when q has
arrived, around each wait on a k or v tile, after each product and each
softmax, and at the end; launches it at the LM prefill shape (q, k, v
[4, 512, 32, 128] bf16, causal); and prints the mean time of each phase
over the launch's CTAs.  The copy lives only under the kernels' build
directory; the port's own kernel is not touched.  The script edits the
source at fixed anchors and stops with a message when they no longer
match.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SLOTS = 64          # time stamps a CTA; slot 63 holds the SM id
CTAS = 8192         # CTAs traced
ITERS = 8           # key-tile iterations traced a CTA


def instrument(src: str) -> str:
    def rep(old, new):
        nonlocal src
        if src.count(old) != 1:
            raise SystemExit(f"flash_trace: anchor not found once in "
                             f"flash_attention.cu: {old[:60]!r}")
        src = src.replace(old, new)

    rep('#include "hopper.cuh"\n',
        '#include "hopper.cuh"\n'
        f'__device__ unsigned long long g_trace[{CTAS} * {SLOTS}];\n'
        f'#define TR(k) do {{ if (tid == 0 && blockIdx.x < {CTAS}) '
        f'g_trace[blockIdx.x * {SLOTS} + (k)] = hopper::global_ns(); }} '
        'while (0)\n')
    rep('''  if (tid == 0) {
    mbar_init(q_full, 1);''', f'''  TR(0);
  if (tid == 0 && blockIdx.x < {CTAS}) {{
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_trace[blockIdx.x * {SLOTS} + 63] = sm;
  }}
  if (tid == 0) {{
    mbar_init(q_full, 1);''')
    rep('''  mbar_wait(q_full, 0);
  if (n > 0) {
    mbar_wait(&k_full[0], 0);
    wgmma_fence();
    issue_qk<HDP>(sc, Qw, Ks);
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(&k_empty[0]);
    softmax_tile(sc, m, l, pa, corr, t, wq0, t_begin * BKV, Skv, causal,
                 window, softcap, scale2);
  }''', '''  mbar_wait(q_full, 0);
  TR(1);
  if (n > 0) {
    mbar_wait(&k_full[0], 0);
    TR(2);
    wgmma_fence();
    issue_qk<HDP>(sc, Qw, Ks);
    wgmma_wait_all();
    fence_regs(sc);
    TR(3);
    mbar_arrive(&k_empty[0]);
    softmax_tile(sc, m, l, pa, corr, t, wq0, t_begin * BKV, Skv, causal,
                 window, softcap, scale2);
    TR(4);
  }''')
    rep('''    mbar_wait(&v_full[sp], (uint32_t)(((i - 1) / S) & 1));
    wgmma_fence();
    issue_pv(o, pa, Vs + sp * TL::TB);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&v_empty[sp]);
    mbar_wait(&k_full[s], (uint32_t)((i / S) & 1));
    wgmma_fence();
    issue_qk<HDP>(sc, Qw, Ks + s * TL::TB);
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(&k_empty[s]);
    softmax_tile(sc, m, l, pa, corr, t, wq0, (t_begin + i) * BKV, Skv,
                 causal, window, softcap, scale2);
#pragma unroll
    for (int e = 0; e < HDP / 2; ++e) o[e] *= corr[(e >> 1) & 1];''',
        f'''    mbar_wait(&v_full[sp], (uint32_t)(((i - 1) / S) & 1));
    if (i <= {ITERS}) TR(5 + 5 * (i - 1));
    wgmma_fence();
    issue_pv(o, pa, Vs + sp * TL::TB);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    if (i <= {ITERS}) TR(6 + 5 * (i - 1));
    mbar_arrive(&v_empty[sp]);
    mbar_wait(&k_full[s], (uint32_t)((i / S) & 1));
    if (i <= {ITERS}) TR(7 + 5 * (i - 1));
    wgmma_fence();
    issue_qk<HDP>(sc, Qw, Ks + s * TL::TB);
    wgmma_wait_all();
    fence_regs(sc);
    if (i <= {ITERS}) TR(8 + 5 * (i - 1));
    mbar_arrive(&k_empty[s]);
    softmax_tile(sc, m, l, pa, corr, t, wq0, (t_begin + i) * BKV, Skv,
                 causal, window, softcap, scale2);
#pragma unroll
    for (int e = 0; e < HDP / 2; ++e) o[e] *= corr[(e >> 1) & 1];
    if (i <= {ITERS}) TR(9 + 5 * (i - 1));''')
    rep('''    mbar_wait(&v_full[sp], (uint32_t)(((n - 1) / S) & 1));
    wgmma_fence();
    issue_pv(o, pa, Vs + sp * TL::TB);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&v_empty[sp]);
  }
''', '''    mbar_wait(&v_full[sp], (uint32_t)(((n - 1) / S) & 1));
    TR(50);
    wgmma_fence();
    issue_pv(o, pa, Vs + sp * TL::TB);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    TR(51);
    mbar_arrive(&v_empty[sp]);
  }
''')
    rep('''    tma_store_wait();
  }
}''', '''    tma_store_wait();
  }
  TR(52);
}''')
    return src + '''
extern "C" int get_trace(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
'''


def build():
    from repro_torch.kernels import _build
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise SystemExit("flash_trace: nvcc not found")
    out = _build.BUILD_DIR / "flash_trace"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "flash_attention_traced.cu"
    src.write_text(instrument((_build.CSRC / "flash_attention.cu").read_text()))
    so = out / "flash_attention_traced.so"
    cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
           str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"flash_trace: nvcc failed:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(so))


def main() -> int:
    import torch
    from repro_torch.kernels import _build, ops
    if not torch.cuda.is_available():
        print("flash_trace: needs a CUDA device", file=sys.stderr)
        return 1
    lib = build()
    entry, argtypes = _build.KERNELS["flash_attention"]
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _build._LIBS["flash_attention"] = lib          # the wrapper calls the copy
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(4, 512, 32, 128, device="cuda",
                           generator=g).bfloat16() for _ in range(3))
    if ops.flash_variant(q.dtype, 128) != "wgmma":
        raise SystemExit("flash_trace: the LM shape no longer takes wgmma")
    for _ in range(3):                             # the last launch is kept
        ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    buf = np.zeros(CTAS * SLOTS, dtype=np.uint64)
    if lib.get_trace(ctypes.c_void_p(buf.ctypes.data)) != 0:
        raise SystemExit("flash_trace: reading the trace failed")
    tr = buf.reshape(CTAS, SLOTS).astype(np.int64)
    tr = tr[tr[:, 52] > 0]                         # CTAs of the launch

    def span(a, b):
        ok = (tr[:, a] > 0) & (tr[:, b] > 0)
        return (tr[ok, b] - tr[ok, a]) / 1e3

    t0 = tr[:, 0].min()
    life = (tr[:, 52] - tr[:, 0]) / 1e3
    print(f"[trace] {torch.cuda.get_device_name(0)} ctas={len(tr)} "
          f"span={(tr[:, 52].max() - t0) / 1e3:.2f}us "
          f"cta_life_mean={life.mean():.2f}us min={life.min():.2f}us "
          f"max={life.max():.2f}us")
    print(f"[trace] start->q {span(0, 1).mean():.3f}us q->k0 "
          f"{span(1, 2).mean():.3f}us qk0 {span(2, 3).mean():.3f}us "
          f"softmax0 {span(3, 4).mean():.3f}us")
    names = ("wait_v", "pv", "wait_k", "qk", "softmax+rescale")
    phases = {name: [] for name in names}
    for i in range(1, ITERS):
        pts = [4 if i == 1 else 9 + 5 * (i - 2)] + [5 + 5 * (i - 1) + j
                                                      for j in range(5)]
        for j, name in enumerate(names):
            phases[name].extend(span(pts[j], pts[j + 1]).tolist())
    print("[trace] per key tile: " + " ".join(
        f"{name} {np.mean(x):.3f}us" for name, x in phases.items() if x))
    print(f"[trace] last pv {span(50, 51).mean():.3f}us epilogue "
          f"{span(51, 52).mean():.3f}us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
