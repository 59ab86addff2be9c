"""K7's dW split over rows (``conv_vjp.k7_dw_chunks``) on the CPU: every
row in exactly one chunk, chunk boundaries on the wgmma kernel's 64-row
k-step, at most one wave of blocks on an H100's 132 SMs, and a plan that
depends on the shape alone, so the fixed-order reduction gives the same
bits every run. K8's dW has its own tile and plan (``k8_dw_tile``,
``k8_dw_chunks``), held to the same rules here."""

import pytest

from kubeoperator_tpu_torch.workloads import conv_vjp as tcv

# ResNet-50's K7 sites at batch 128, 224² (n, ci, co): stage 1 conv1 and
# conv3, stage 2 block 0 conv1, blocks 1-5 conv1, conv3, stage 3 block 0
# conv1, blocks 1-2 conv1, conv3
PATH_SITES = [(100352, 512, 128), (100352, 128, 512), (100352, 512, 256),
              (25088, 1024, 256), (25088, 256, 1024), (25088, 1024, 512),
              (6272, 2048, 512), (6272, 512, 2048)]
# the shapes of tests/test_torch_conv_cuda.py and a few ragged ones
TEST_SHAPES = [(128, 64, 128), (1000, 128, 64), (6272, 256, 192),
               (300, 64, 64), (777, 64, 192), (4000, 192, 64), (1, 64, 64),
               (65, 128, 128)]
SHAPES = PATH_SITES + TEST_SHAPES


def chunk_ranges(n, rows, chunks):
    return [(z * rows, min(n, (z + 1) * rows)) for z in range(chunks)]


@pytest.mark.parametrize("n,ci,co", SHAPES)
def test_k7_chunks_cover_every_row_once_on_the_k_step(n, ci, co):
    rows, chunks = tcv.k7_dw_chunks(n, ci, co)
    assert rows % tcv.K7_ROW_STEP == 0
    ranges = chunk_ranges(n, rows, chunks)
    # contiguous, non-empty, in order, from 0 to n: each row exactly once
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    assert all(b > a for a, b in ranges)
    # every boundary but the end of the rows falls on a k-step
    assert all(a % tcv.K7_ROW_STEP == 0 for a, _ in ranges)


@pytest.mark.parametrize("n,ci,co", SHAPES)
def test_k7_plan_is_a_function_of_the_shape(n, ci, co):
    plan = tcv.k7_dw_chunks(n, ci, co)
    assert all(tcv.k7_dw_chunks(n, ci, co) == plan for _ in range(3))
    rows, chunks = plan
    tiles = -(-ci // tcv.K7_TILE) * -(-co // tcv.K7_TILE)
    # never more than one wave of blocks, and no more chunks than
    # K7_MIN_ROWS-row pieces of N
    assert tiles * chunks <= max(tcv.SMS, tiles)
    assert chunks <= -(-n // tcv.K7_MIN_ROWS)
    if (n, ci, co) in PATH_SITES:      # the path fills >= 96% of the wave
        assert tiles * chunks >= 0.96 * tcv.SMS


# K8's sites in a ResNet-50 step at batch 128, 224² (chip_smoke.K8_SITES)
# and the shapes the mma.sync plan was pinned at
K8_SHAPES = [(401408, 64, 64), (401408, 256, 64), (401408, 64, 256),
             (401408, 256, 128), (100352, 128, 512),
             (100352, 64, 256), (25088, 128, 512), (1000, 64, 256),
             (4100, 192, 128)]


@pytest.mark.parametrize("n,ci,co", K8_SHAPES)
def test_k8_keeps_its_own_plan(n, ci, co):
    """K8's wgmma dW splits rows by ``k8_dw_chunks`` on its own block tile
    (``k8_dw_tile``, as conv_bwd.cu's ``k8_dw`` picks it) and K7's 64-row
    k-step: every row in exactly one chunk, boundaries on the k-step, a
    plan that depends on the shape alone, and at most one wave of blocks."""
    plan = tcv.k8_dw_chunks(n, ci, co)
    assert all(tcv.k8_dw_chunks(n, ci, co) == plan for _ in range(3))
    rows, chunks = plan
    assert rows % tcv.K7_ROW_STEP == 0
    ranges = chunk_ranges(n, rows, chunks)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    assert all(b > a for a, b in ranges)
    tm, tn = tcv.k8_dw_tile(ci, co)
    assert ci % tm == 0 and co % tn == 0
    tiles = (ci // tm) * (co // tn)
    assert tiles * chunks <= max(tcv.SMS, tiles)
    assert chunks <= -(-n // tcv.K7_MIN_ROWS)
    if n == 401408:                    # the path fills >= 96% of the wave
        assert tiles * chunks >= 0.96 * tcv.SMS


@pytest.mark.parametrize("ci,co,tile", [
    (64, 64, (64, 64)), (256, 64, (128, 64)), (64, 256, (64, 256)),
    (256, 128, (128, 128)), (128, 512, (128, 128)), (192, 128, (64, 64))])
def test_k8_dw_tile_is_the_kernels(ci, co, tile):
    """No block tile is half zeros: 64-channel sides take 64-wide tiles,
    and 64 -> 256 reads x and forms dy once (one 64 x 256 tile)."""
    assert tcv.k8_dw_tile(ci, co) == tile
