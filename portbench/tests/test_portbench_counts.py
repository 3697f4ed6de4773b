"""The operation and byte counts at small shapes, worked by hand."""
import json

import pytest

from tiny import DATA
from portbench.counts import flash_attention as fa
from portbench.counts import prefill


def tiny(name="tiny-dense"):
    return json.loads((DATA / f"{name}.json").read_text())


@pytest.mark.parametrize("S,window,pairs", [
    (4, 0, 10),            # 1 + 2 + 3 + 4
    (5, 2, 9),             # 1 + 2 + 2 + 2 + 2
    (3, 8, 6),             # a window past the prompt is global
    (1024, 0, 524800),
])
def test_visible_pairs(S, window, pairs):
    assert fa.visible_pairs(S, window) == pairs


def test_flash_calls_dense():
    # H = K = 4, hd = 16; 2 rows of 4 tokens: 10 pairs a row and head
    calls = fa.calls(tiny(), rows=2, tokens=4)
    assert len(calls) == 2
    flops, nbytes = calls[0]
    assert flops == 4 * 16 * 4 * 2 * 10          # q.k and p.v, 2 * hd each
    assert nbytes == 2 * (2 * 4 * 16) * (4 + 4 + 4 + 4)   # q, o, k, v bf16


def test_flash_calls_hybrid_window():
    # layer 1 windowed at 8; 24 tokens: 36 + 16 * 8 = 164 pairs
    calls = fa.calls(tiny("tiny-hybrid"), rows=1, tokens=24)
    assert [c[0] for c in calls] == [4 * 16 * 4 * p
                                     for p in (300, 164, 300, 300)]
    assert calls[0][1] == 2 * 24 * 16 * (2 * 4 + 2 * 2)


def test_bound_takes_the_larger_term():
    peaks = {"bf16_flop_per_s": 100.0, "hbm_bytes_per_s": 10.0}
    assert fa.bound_seconds(1000.0, 50.0, peaks) == 10.0
    assert fa.bound_seconds(100.0, 50.0, peaks) == 5.0


def test_prefill_flops_dense():
    # d 64, H = K = 4 of 16, f 128, V 256, 2 layers; 1 row of 2 tokens
    T = 2
    per_layer = (2 * T * 64 * (64 + 128)          # q, k, v
                 + 2 * T * 64 * 64                # wo
                 + 4 * 16 * 4 * 3                 # 3 visible pairs
                 + 2 * T * 3 * 64 * 128)          # w1, w3, w2
    assert prefill.flops(tiny(), rows=1, tokens=T) == \
        2 * per_layer + 2 * 64 * 256


def test_prefill_flops_hybrid_adds_the_mixer():
    cfg = tiny("tiny-hybrid")
    dense = dict(cfg, architecture="dense")
    T = 24
    # din 128, 8 heads of 16, state 16, conv 4 over 128 + 32 channels
    mixer = (2 * T * 64 * (2 * 128 + 2 * 16 + 8) + 2 * T * 128 * 64
             + 2 * T * 4 * 160 + 4 * T * 8 * 16 * 16)
    windows_diff = 4 * 16 * 4 * (300 - 164)     # layer 1 sees fewer pairs
    assert prefill.flops(cfg, 1, T) == pytest.approx(
        prefill.flops(dense, 1, T) + 4 * mixer - windows_diff)


def test_counts_of_a_new_architecture_come_from_its_module(tiny_root):
    # the toy MoE: d 64, 4 heads over 2 KV heads of 16; a dense first
    # layer of d_ff 128, then 2 expert layers routing each token to 2 of
    # 4 experts of 32; V 256; 1 row of 2 tokens
    from portbench import archs
    cfg = archs.read_config(tiny_root / "portbench", "tiny-moe")
    T = 2
    attn = (2 * T * 64 * (64 + 2 * 32)            # q, k, v
            + 2 * T * 64 * 64                     # wo
            + 4 * 16 * 4 * 3)                     # 3 visible pairs
    dense = 2 * T * 3 * 64 * 128
    moe = 2 * T * 64 * 4 + 2 * (2 * T * 3 * 64 * 32)    # router, 2 experts
    assert prefill.flops(cfg, rows=1, tokens=T) == \
        3 * attn + dense + 2 * moe + 2 * 64 * 256
    assert fa.calls(cfg, rows=1, tokens=T) == [
        (4 * 16 * 4 * 3, 2 * T * 16 * (2 * 4 + 2 * 2))] * 3
