"""The split-KV rule of the paged kernels (``kv_splits``), on the CPU.

The wrappers pick S, the number of blocks that share one work item's
K/V walk, from the launch's shapes alone. These tests pin the rule: S is
a power of two from 1 to MAX_SPLITS, never more than the pages (decode)
or 64-row tiles (chunk, tree) a walk can have, 1 when the grid already
fills SPLIT_WAVES waves on SPLIT_SMS SMs (the chunk kernel's serving
grid, which so stays the unsplit kernel bit for bit), and the same for
the chunk and tree modes at equal shapes (so a tree of causal masks
walks exactly as the chunk kernel does).
"""

import itertools

import pytest

from gofr_tpu_torch.ops.paged_attention import (CHUNK_KV_TILE, CHUNK_ROWS,
                                                MAX_SPLITS, SPLIT_SMS,
                                                SPLIT_WAVES, kv_splits)

# (batch, sq, hq, hkv, max_pages, page): the smoke's and the engine's
# shapes, then edges
SHAPES = [
    (8, 1, 32, 8, 24, 64),        # decode at the smoke's batch
    (1, 1, 32, 8, 32, 64),        # one request
    (4, 1024, 32, 8, 32, 64),     # the widest chunk bucket
    (8, 16, 32, 8, 32, 64),       # a tree verify, 16 wide
    (1, 16, 32, 8, 32, 64),
    (3, 5, 8, 2, 1, 16),          # one page: S = 1
    (2, 32, 16, 1, 3, 16),        # group 16
    (64, 1, 32, 8, 32, 64),       # large batch: S = 1
    (2, 70, 4, 4, 40, 16),        # group 1, several q tiles
    (1, 1, 8, 2, 5, 128),         # pages larger than a tile
]


def _blocks_units(mode, batch, sq, hq, hkv, max_pages, page):
    if mode == "decode":
        return batch * hkv, max_pages
    q_tiles = -(-sq // (CHUNK_ROWS // (hq // hkv)))
    return batch * hkv * q_tiles, -(-max_pages * page // CHUNK_KV_TILE)


@pytest.mark.parametrize("mode,shape", list(itertools.product(
    ("decode", "chunk", "tree"), SHAPES)))
def test_splits_are_bounded_and_fill_about_two_waves(mode, shape):
    s = kv_splits(mode, *shape)
    blocks, units = _blocks_units(mode, *shape)
    assert 1 <= s <= MAX_SPLITS and s & (s - 1) == 0
    assert s <= max(1, units)
    if mode == "decode" or shape[-1] <= CHUNK_KV_TILE:
        assert s <= shape[4]              # never above the pages
    assert s == 1 or s * blocks <= SPLIT_WAVES * SPLIT_SMS
    # the largest such S: doubling it would break a bound
    assert (2 * s > MAX_SPLITS or 2 * s > units
            or 2 * s * blocks > SPLIT_WAVES * SPLIT_SMS)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] <= 32])
def test_chunk_and_tree_take_the_same_splits(shape):
    assert kv_splits("chunk", *shape) == kv_splits("tree", *shape)


@pytest.mark.parametrize("mode,shape,want", [
    ("chunk", (4, 1024, 32, 8, 32, 64), 1),   # 2,048 blocks: unsplit
    ("decode", (8, 1, 32, 8, 24, 64), 4),     # 64 blocks -> 256
    ("tree", (8, 16, 32, 8, 32, 64), 4),
    ("decode", (1, 1, 32, 8, 32, 64), 8),     # one request: 8 blocks -> 64
    ("tree", (1, 16, 32, 8, 30, 64), 8),
    ("decode", (4, 1, 32, 8, 16, 64), 8),     # the profile's B=4 step
    ("decode", (3, 1, 8, 2, 1, 16), 1),       # one page: nothing to split
])
def test_serving_shapes(mode, shape, want):
    assert kv_splits(mode, *shape) == want


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown mode"):
        kv_splits("prefill", 1, 1, 8, 8, 4, 64)
