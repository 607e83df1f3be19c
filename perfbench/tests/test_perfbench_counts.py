"""Operation and byte counts against hand counts."""

import pytest

from perfbench import counts, weights
from perfbench.harness import load_json
from perfbench.harness import HERE

BYT5 = load_json(HERE, "configs", "byt5-small-tacgen.json")
SMALL = dict(d_model=4, d_ff=6, num_heads=2, d_kv=3, num_layers=2, num_decoder_layers=1,
             vocab_size=10, relative_attention_num_buckets=4)


def test_perfbench_dense_flops_per_token_byt5():
    # q, k, v, o: 4 products of 1472 x 384; wi 1472 x 7168 and wo 3584 x 1472.
    assert counts.dense_flops_per_token(BYT5) == 2 * (4 * 1472 * 384 + 1472 * 7168 + 3584 * 1472)


def test_perfbench_encoder_flops_by_loops():
    rows, length = 3, 5
    inner = SMALL["num_heads"] * SMALL["d_kv"]
    hand = 0
    for _ in range(SMALL["num_layers"]):
        for _ in range(rows * length):
            hand += 2 * SMALL["d_model"] * inner * 4          # q, k, v, o
            hand += 2 * SMALL["d_model"] * 2 * SMALL["d_ff"]  # gate | up
            hand += 2 * SMALL["d_ff"] * SMALL["d_model"]      # out
            hand += 2 * length * inner * 2                     # scores, weighted values
    assert counts.encoder_flops(SMALL, rows, length) == hand


def test_perfbench_decode_step_flops_by_loops():
    rows, cache, src = 4, 7, 9
    d, f, v = SMALL["d_model"], SMALL["d_ff"], SMALL["vocab_size"]
    inner = SMALL["num_heads"] * SMALL["d_kv"]
    per_row = 0
    for _ in range(SMALL["num_decoder_layers"]):
        per_row += 2 * d * inner * 4 + 2 * d * inner * 2       # self q k v o, cross q o
        per_row += 2 * d * 2 * f + 2 * f * d                   # MLP
        per_row += 2 * 2 * (cache + 1) * inner + 2 * 2 * src * inner
    per_row += 2 * d * v
    assert counts.decode_step_flops(SMALL, rows, cache, src) == rows * per_row


def test_perfbench_cross_kv_flops():
    assert counts.cross_kv_flops(SMALL, 2, 5) == 1 * 2 * (2 * 2 * 5 * 4 * 6)


def test_perfbench_attention_bytes_and_bound():
    # q, k, v read and the output written in bf16, the int32 mask read.
    assert counts.encoder_attention_bytes(BYT5, 64, 128) == 4 * 64 * 128 * 384 * 2 + 4 * 64 * 128
    t, by = counts.encoder_attention_bound_s(BYT5, 64, 1024)
    assert by == "operations"
    assert t == pytest.approx(4 * 64 * 1024 * 1024 * 384 / counts.PEAK_BF16_FLOPS)
    _, by = counts.encoder_attention_bound_s(BYT5, 1, 16)
    assert by == "bytes"


def test_perfbench_mfu_pct():
    assert counts.mfu_pct(989e12, 1.0) == pytest.approx(100.0)
    assert counts.mfu_pct(989e12, 2.0, chips=4) == pytest.approx(12.5)


@pytest.mark.parametrize("tokens,expect", [(1, 128), (128, 128), (129, 256), (1024, 1024),
                                           (5000, 1024)])
def test_perfbench_padded_length(tokens, expect):
    assert counts.padded_length(tokens, 128, 1024) == expect


def test_perfbench_batch_lengths_sorted():
    assert counts.batch_lengths([300, 5, 130, 129, 2], 2, 128, 1024) == [128, 256, 384]


def test_perfbench_parameter_count_matches_published():
    # google/byt5-small: 299,637,760 parameters with an untied output layer.
    assert weights.parameter_count(BYT5) == 299_637_760
