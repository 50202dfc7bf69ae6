"""The yardstick's counts against hand counts at the cells' shapes."""
import json

import pytest

from bench.harness import counts, spec


def conf(name):
    return json.loads((spec.BENCH / "configs" / f"{name}.json").read_text())


def test_product_params_granite_by_hand():
    c = conf("granite-20b")
    # a layer: wq 6144x6144, wk and wv 6144x128 each, wo 6144x6144; w_up and
    # w_down 6144x24576 each; then the head 49152x6144
    layer = 6144 * 6144 * 2 + 6144 * 128 * 2 + 6144 * 24576 * 2
    assert layer == 379_060_224
    assert counts.product_params(c) == 52 * layer + 49152 * 6144 == 20_013_121_536


def test_product_params_yi_by_hand():
    c = conf("yi-6b-8l")
    layer = 4096 * 4096 * 2 + 4096 * 512 * 2 + 3 * 4096 * 11008
    assert layer == 173_015_040
    assert counts.product_params(c) == 8 * layer + 64000 * 4096


@pytest.mark.parametrize("name, batch, seq, expect", [
    # granite-20b.train_layered: 6 N T with N = 6 layers + head; attention 6 S^2 Hq hd
    ("granite-20b-6l", 8, 2048,
     6 * (6 * 379_060_224 + 49152 * 6144) * 8 * 2048 + 8 * 6 * 6 * 2048 ** 2 * 48 * 128),
    # yi-6b.train_long16k
    ("yi-6b-8l", 4, 16384,
     6 * (8 * 173_015_040 + 64000 * 4096) * 4 * 16384 + 4 * 8 * 6 * 16384 ** 2 * 32 * 128),
])
def test_train_step_flops(name, batch, seq, expect):
    assert counts.train_step_flops(conf(name), batch, seq) == expect


def test_train_step_flops_yi_full_depth_pipeline_shape():
    # the four-card cell's shape (full depth, 16 x 2048), kept for a later PR
    c = dict(conf("yi-6b-8l"), num_hidden_layers=32)
    n = 32 * 173_015_040 + 64000 * 4096
    assert counts.train_step_flops(c, 16, 2048) == \
        6 * n * 16 * 2048 + 16 * 32 * 6 * 2048 ** 2 * 32 * 128


def test_serving_flops_granite():
    c = conf("granite-20b")
    n = 20_013_121_536
    assert counts.prefill_flops(c, 1536) == 2 * n * 1536 + 52 * 2 * 1536 ** 2 * 48 * 128
    assert counts.decode_flops(c, 1600) == 2 * n + 52 * 4 * 1600 * 48 * 128


def test_attention_counts_by_hand():
    # granite's training call: q [2, 2048, 48, 128], k/v [2, 2048, 1, 128]
    f, b = counts.attention_fwd(2, 2048, 2048, 48, 1, 128)
    pairs = 2048 * 2049 // 2
    assert f == 4 * 2 * 48 * 128 * pairs
    assert b == 2 * 2 * (2048 * 48 * 128 * 2 + 2 * 2048 * 128) + 4 * 2 * 48 * 2048
    fb, bb = counts.attention_bwd(2, 2048, 2048, 48, 1, 128)
    assert fb == 2.5 * f
    assert bb == 2 * 2 * (3 * 2048 * 48 * 128 + 2 * 2048 * 128) + 4 * 2 * 48 * 2048 \
        + 2 * 2 * (2048 * 48 * 128 + 2 * 2048 * 128)
    # bound by operations at this shape: about 0.104 ms
    assert counts.bound_s(f, b) == pytest.approx(f / 989e12)
    assert 1.0e-4 < counts.bound_s(f, b) < 1.1e-4


def test_paged_bytes_by_hand():
    # 64 slots of granite, 2000 live positions each
    assert counts.paged_decode_bytes(64, 48, 1, 128, 128000) == \
        2 * (2 * 64 * 48 * 128 + 2 * 128000 * 128)
