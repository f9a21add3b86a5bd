"""The analytic counts behind ``mfu`` and the two roofline shares, held to
counts made by hand at one decode and one suffix-prefill shape."""

import pytest

from portbench import manifest
from portbench.counts import transformer as c
from portbench.tests.smoke import DSMOE_MODEL as DSMOE

DS7B = manifest.Manifest().config("ds7b")["model"]

# deepseek-7b: 30 layers of q, k, v, o (4096 x 4096 each) and a SwiGLU MLP
# (3 x 4096 x 11008)
P7B = 30 * (4 * 4096 * 4096 + 3 * 4096 * 11008)
# deepseekmoe-16b: one dense layer (4 x 2048^2 + 3 x 2048 x 10944), then 27
# of attention, a 64-wide router and 6 routed + 2 shared experts of
# 3 x 2048 x 1408
PMOE = (4 * 2048 ** 2 + 3 * 2048 * 10944) \
    + 27 * (4 * 2048 ** 2 + 2048 * 64 + 8 * 3 * 2048 * 1408)
HEAD7B = 2 * 4096 * 102400
ATTN7B = 4 * 32 * 128 * 30            # per query-key pair, all layers


def test_matmul_parameters():
    assert c.token_params(DS7B) == P7B == 6_071_255_040
    assert c.token_params(DSMOE) == PMOE == 2_409_103_360


def test_decode_step():
    # two rows whose new tokens see 100 and 300 keys
    assert c.decode_flops(DS7B, [100, 300]) == \
        2 * (2 * P7B + HEAD7B) + ATTN7B * 400
    # one paged call (a layer): K and V of their 400 tokens (32 heads x 128,
    # bf16), and for 32 rows q and out (bf16), heat and table (4 bytes)
    # over 128 blocks
    assert c.paged_bytes(DS7B, 400, 32, 128) == \
        400 * 32 * 128 * 2 * 2 + 32 * (2 * 32 * 128 * 2 + 128 * 8)


def test_suffix_prefill():
    # 64 new tokens after a cached 1,536-token document: token i sees
    # 1536 + i + 1 keys
    keys = sum(1536 + i + 1 for i in range(64))
    assert keys == 100_384
    assert c.prefill_flops(DS7B, 64, 1536) == \
        2 * P7B * 64 + ATTN7B * keys + HEAD7B
    # its flash call: 4 padded blocks of queries at offset 1536 over the
    # 100 blocks of keys
    f, b = c.flash_cost(DS7B, 64, 1600, 1536)
    assert f == 4 * 32 * 128 * keys
    assert b == (2 * 64 * 32 * 128 + 2 * 1600 * 32 * 128) * 2


def test_full_prefill_is_causal():
    f, _ = c.flash_cost(DS7B, 128, 128, 0)
    assert f == 4 * 32 * 128 * (128 * 129 // 2)
    assert c.prefill_flops(DS7B, 128, 0) == pytest.approx(
        2 * P7B * 128 + ATTN7B * 128 * 129 / 2 + HEAD7B)


def test_shared_blocks_count_once():
    """The paged bound's KV tokens: a pool block that several rows read
    (a document shared through the prefix cache) is one input."""
    from types import SimpleNamespace

    import numpy as np

    from portbench.serve import Entries
    host = np.full((3, 8), -1, np.int32)
    host[0, :3] = [5, 6, 7]          # 40 tokens: blocks 5, 6 shared
    host[1, :3] = [5, 6, 9]          # 36 tokens
    host[2, :2] = [11, 12]           # inactive
    eng = SimpleNamespace(layout=SimpleNamespace(block_tokens=16),
                          _tables=SimpleNamespace(host=host))
    info = Entries(eng, None, tables=True)._decode_info(
        None, np.array([39, 35, 20]), np.array([1, 1, 0]))
    assert list(info["contexts"]) == [40, 36]
    assert info["kv_tokens"] == 16 + 16 + 8 + 4
