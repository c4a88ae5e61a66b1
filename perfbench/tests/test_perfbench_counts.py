"""The work counts against hand counts at small shapes, and the metric
arithmetic on synthetic requests and timelines."""
import math

import pytest

from benchlib import cells, stats, work
from benchlib.runner import Run
from benchlib.traffic import Shape
from counts import lm as counts
from loops.serve import Request

# one MoE attention layer: d 8, 2 heads of 4 (1 KV head), experts of 16,
# 4 experts top-2, vocabulary 10
MOE = dict(n_layers=1, d_model=8, n_heads=2, n_kv_heads=1, d_ff=16,
           vocab=10, sliding_window=0, moe=dict(n_experts=4, top_k=2),
           period=[dict(kind="attn", moe=True)])
# the same layer with a dense SwiGLU FFN
DENSE = dict(MOE, moe=None, period=[dict(kind="attn", moe=False)])
PK = dict(bf16_flops=1000.0, fp32_flops=100.0, hbm_bytes=10.0)


def test_causal_pairs():
    assert work.causal_pairs(4) == 10
    # window 2 over 4 queries: 1 + 2 + 2 + 2
    assert work.causal_pairs(4, 2) == 7
    assert work.causal_pairs(4, 4) == 10


def test_flash_attention_call_by_hand():
    w = work.flash_attention_call(1, 2, 1, 4, 8, 0, 2)
    assert w["flops"] == 4 * 2 * 8 * 10          # QK^T and PV, 10 pairs
    # q and o 2 x 4 x 8, k and v 1 x 4 x 8 elements, 2 bytes each
    assert w["bytes"] == 2 * (64 + 32 + 32 + 64)


def test_prefill_flops_by_hand():
    # a token: q 2*8*8, k and v 2*8*4 each, o 2*8*8 = 384; router 2*8*4,
    # two experts of three 2*8*16 products = 1,600
    per_token = 384 + 64 + 1536
    pairs = 4 * 2 * 4 * 6             # 3 queries, 6 causal pairs
    head = 2 * 8 * 10                 # the served position only
    assert counts.prefill_flops(MOE, 1, 3) == 3 * per_token + pairs + head


def test_dense_token_flops_by_hand():
    # attention 384; three 2*8*16 products; the head 2*8*10
    assert counts.prefill_flops(DENSE, 1, 1) == 384 + 768 + 4 * 2 * 4 + 160


def test_decode_step_flops_by_hand():
    # a token's layer 1,984 (as above), QK^T and PV over 5 keys, the head
    assert counts.decode_step_flops(MOE, 2, 5) == \
        2 * 1984 + 4 * 2 * 2 * 4 * 5 + 2 * 2 * 8 * 10
    # a window of 3 reads 3 keys
    assert counts.decode_step_flops(dict(MOE, sliding_window=3), 1, 5) == \
        1984 + 4 * 2 * 4 * 3 + 2 * 8 * 10


def test_decode_step_bytes_by_hand():
    # embedding row 16, head 160, logits 20, final norm 16 (bf16 bytes)
    outer = 2 * (8 + 80 + 10 + 8)
    norms = 2 * 2 * 8
    attn_w = 2 * (8 * 16 + 8 * 8)
    kv = 2 * 5 * 4 * 2 + 2 * 4 * 2   # K and V: 5 positions read, 1 written
    router = 2 * 8 * 4
    experts = lambda n: 2 * n * 3 * 8 * 16
    got = counts.decode_step_bytes(MOE, 1, 5, [3])
    assert got == outer + norms + attn_w + kv + router + experts(3)
    assert counts.decode_step_bytes(MOE, 1, 5) == \
        outer + norms + attn_w + kv + router + experts(4)


def test_percentile_nearest_rank_and_rates():
    xs = [float(i) for i in range(1, 11)]
    assert stats.percentile(xs, 90) == 9.0
    assert stats.percentile(xs + [11.0], 90) == 10.0
    assert stats.percentile([], 90) is None
    assert stats.rate([100, 300], 1.0, 3.0) == 200.0
    assert stats.rate([], 1.0, 3.0) is None


def test_union_of_overlapping_intervals_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 12)]
    assert stats.union_length(iv) == 3 + 1 + 4
    assert stats.union_length(iv, 1, 10) == 2 + 1 + 2
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def _run(requests, trace=None, c=MOE):
    return Run(c=c, counts=counts, requests=requests, t_start=10.0,
               t_end=max(r.t_done for r in requests), setup_s=1.5,
               peaks=PK, trace=trace)


def test_end_to_end_readers_on_synthetic_requests():
    reqs = [Request(Shape(4, 512, 1), 10.0, 10.5, 0.4, 0.0),
            Request(Shape(2, 1024, 1), 10.5, 11.5, 0.9, 0.0),
            Request(Shape(1, 2048, 1), 11.5, 12.0, 0.45, 0.0)]
    run = _run(reqs)
    assert cells.reader("prefill_tok_s")(run) == pytest.approx(6144 / 2.0)
    p90 = cells.reader("ttft_ms.p90")(run)
    assert p90 == dict(value=1000.0, samples=3)
    assert cells.reader("setup_s")(run) == 1.5
    chat = [Request(Shape(16, 256, 64), 10.0, 15.0, 0.2, 4.8)]
    run = _run(chat)
    assert cells.reader("output_tok_s")(run) == pytest.approx(1024 / 5.0)
    assert cells.reader("ttft_ms.p90")(run) is None
    assert cells.reader("decode_step_ms")(run)["value"] == \
        pytest.approx(4800 / 63)


def test_trace_readers_on_a_synthetic_timeline():
    reqs = [Request(Shape(1, 4, 1), 10.0, 11.0, 0.5, 0.0),
            Request(Shape(1, 4, 1), 11.0, 12.0, 0.5, 0.0)]
    trace = dict(window_s=2.0, busy_s=1.5,
                 span_device_s={"pb.moe.prefill": 0.6},
                 op_device_s={"void flash_attention_kernel<2>(...)": 1e-3,
                              "other": 1.0})
    run = _run(reqs, trace)
    assert cells.reader("idle_share.prefill")(run) == pytest.approx(25.0)
    assert cells.reader("moe_ms.prefill")(run) == pytest.approx(300.0)
    # each call: 4*2*4*10 = 320 flops -> 0.32 s at 1000; 2*(32+16+16+32)
    # = 192 bytes -> 19.2 s at 10: bytes bound, two calls
    share = cells.reader("flash_attention.roofline")(run)
    assert share == pytest.approx(100.0 * 2 * 19.2 / 1e-3)
    mfu = cells.reader("mfu.prefill")(run)
    assert mfu == pytest.approx(
        100.0 * 2 * counts.prefill_flops(MOE, 1, 4) / (1.0 * 1000.0))
    assert cells.reader("moe_ms.decode")(run) is None


def test_sub_seeds_take_large_seeds():
    a = cells.sub_seed(2**31 + 5, "weights")
    assert 0 <= a < 2**63 and a != cells.sub_seed(2**31 + 6, "weights")
    assert a == cells.sub_seed(2**31 + 5, "weights")
    assert math.isfinite(a)
