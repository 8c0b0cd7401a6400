"""The tails, rates and counts, against small cases worked by hand."""

import types

import pytest

from portbench import readers, traffic, yardstick as ys

SMALL = ys.Shape(dim=8, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=2,
                 hidden_dim=16, vocab_size=10)
MOE = ys.Shape(dim=8, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=2,
               hidden_dim=16, vocab_size=10, n_experts=4, top_k=2)


def test_percentile_nearest_rank():
    vals = list(range(1, 11))
    assert ys.percentile(vals, 90) == 9
    assert ys.percentile(vals, 100) == 10
    assert ys.percentile(vals, 50) == 5
    assert ys.percentile([3.0], 90) == 3.0
    with pytest.raises(ValueError):
        ys.percentile([], 90)


def _run(reqs, end=100.0, open_=0.0, close=10.0):
    return types.SimpleNamespace(
        window={"counted": reqs, "all": reqs, "end": end, "open": open_,
                "close": close},
        mix={"loop": "open"}, kind="serve", seconds=close - open_)


def _req(due, times, done=True):
    r = traffic.Request(index=0, prompt=[1], max_new=len(times), due_s=due)
    r.times, r.done = list(times), done
    return r


def test_ttft_counts_unfinished_requests():
    reqs = [_req(float(i), [i + 0.1]) for i in range(9)]
    reqs.append(_req(9.0, [], done=False))
    ttft = readers.ttft_s(_run(reqs, end=50.0))
    assert ttft[-1] == pytest.approx(41.0)
    assert ys.percentile(ttft, 90) == pytest.approx(0.1)
    assert ys.percentile(ttft, 100) == pytest.approx(41.0)
    # with two unfinished of ten, the 90th percentile is a missed one
    reqs[-2] = _req(8.0, [], done=False)
    assert ys.percentile(readers.ttft_s(_run(reqs, end=50.0)), 90) \
        == pytest.approx(41.0)


def test_tpot_and_rate():
    reqs = [_req(0.0, [1.0, 1.5, 2.0, 2.5]), _req(0.0, [11.0, 12.0])]
    assert sorted(readers.tpot_s(_run(reqs))) == [0.5, 1.0]
    assert readers.tokens_in_window(_run(reqs)) == 4


def test_weight_counts():
    # q 8x8, k 8x4, v 8x4, o 8x8 = 192; ffn 3 x 8 x 16 = 384
    assert SMALL.attn_weights == 192
    assert SMALL.ffn_weights_active == 384
    assert MOE.ffn_weights_active == 2 * 384 + 8 * 4
    assert SMALL.head_weights == 80


def test_serve_flops():
    # 3 tokens, 6 attended pairs a layer, 1 head row
    per_layer = 2 * 3 * (192 + 384) + 4 * 4 * 2 * 6
    assert ys.serve_flops(SMALL, 3, 6, 1) == 2 * per_layer + 2 * 80
    assert ys.causal_pairs(0, 3) == 6
    assert ys.causal_pairs(5, 2) == 6 + 7


def test_decode_bytes():
    # a length-3 sequence: 3 k and 3 v vectors of 2 heads x 2 dims in bf16,
    # its query and output of 4 heads x 2 dims
    assert ys.decode_attention_bytes(SMALL, [3]) == 2 * 3 * 8 + 2 * 16
    assert ys.decode_attention_bytes(SMALL, [3, 0]) == 48 + 32 + 32


def test_train_flops_leaves_out_recompute():
    b, t = 2, 3
    n = b * t
    attn = 4 * 4 * 2 * b * 6
    layers = 2 * (2 * n * (192 + 384) + attn)
    fwd = layers + 2 * n * 80
    dx = layers + 2 * attn + 2 * n * 80
    assert ys.train_flops(SMALL, b, t, lora=True) == \
        fwd + dx + 2 * 2 * n * 192
    assert ys.train_flops(SMALL, b, t, lora=False) == \
        fwd + dx + 2 * 2 * n * (192 + 384) + 2 * n * 80


def test_flash_bound():
    b, t = 1, 4
    pairs = 10
    q = 4 * 4 * 2 * 2
    kv = 4 * 2 * 2 * 2
    fwd = max(4 * 4 * 2 * pairs / ys.BF16_FLOP_PER_S,
              (2 * q + 2 * kv) / ys.HBM_BYTES_PER_S)
    bwd = max(10 * 4 * 2 * pairs / ys.BF16_FLOP_PER_S,
              (4 * q + 4 * kv) / ys.HBM_BYTES_PER_S)
    assert ys.flash_bound_s(SMALL, b, t, False) == pytest.approx(fwd)
    assert ys.flash_bound_s(SMALL, b, t, True) == pytest.approx(bwd)


def test_trace_union_and_gaps():
    from portbench import trace
    spans = [(0, 10, "a"), (5, 15, "b"), (20, 30, "a")]
    assert trace.union_ns(spans) == 25
    assert trace.idle_ns(spans) == [(15, 20)]
