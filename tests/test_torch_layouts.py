"""The launch layouts of K1-K8: each kernel's `layouts` and its planner.

The planners' picks at every kernel site of the benchmark's four cells are
pinned in a table; each `layouts` holds its planner's pick, and every
layout it lists passes the fit test the wrappers hold a given ``plan`` to.
K1 plans on the stand-in card of `test_torch_nn_split` (the CUDA occupancy
calculator is not there on the CPU); the others on the H100's 132
multiprocessors, as a CPU call does."""

import pytest

from icp_slam_yolo_tpu_torch.ops.pallas import c2f_fused as c2f
from icp_slam_yolo_tpu_torch.ops.pallas import conv_fused as conv
from icp_slam_yolo_tpu_torch.ops.pallas import icp_fused as k1
from icp_slam_yolo_tpu_torch.ops.pallas import nn_kernel as nn
from icp_slam_yolo_tpu_torch.ops.pallas import raster_fused as rf
from icp_slam_yolo_tpu_torch.ops.pallas.c2f_fused import C2fPlan
from icp_slam_yolo_tpu_torch.ops.pallas.conv_fused import ConvPlan
from icp_slam_yolo_tpu_torch.ops.pallas.icp_fused import IcpPlan
from icp_slam_yolo_tpu_torch.ops.pallas.nn_kernel import NnPlan
from icp_slam_yolo_tpu_torch.ops.pallas.raster_fused import RasterPlan
from test_torch_nn_split import CARD

# (cell, the planner's shape arguments, its pick): the SLAM cells' step at
# B = 256 with the fleet configuration's slots (512 source, 24576 map, the
# 864 x 1024 grids' 384 x 384 window, 512 rays of 144 samples, K4 in place),
# and every distinct K5-K8 site of v8n at 640 px and of YOLO12-L at 1024 px
# at batch 32 in bfloat16: (batch, output H, W, Cin, Cout, k) for K5-K7,
# (batch, H, W, Cin, c, F) for K8
PICKS = [
    ("fleet-b256/shared-r256", (256, 512, 24576), IcpPlan(2, 8, True, 43008)),
    ("fleet-b256/shared-r256", (256, 512, 512, 132), NnPlan(16, 1)),
    ("fleet-b256/shared-r256", (256, 864, 1024, 384, 384, 512, 144), RasterPlan(512, 113816, 0, 0, 0, 1)),
    ("detect-b32", (32, 20, 20, 64, 1, 1), ConvPlan(False, 64, 16, 1, False, False)),
    ("detect-b32", (32, 20, 20, 64, 64, 1), ConvPlan(True, 32, 64, 1, False, False)),
    ("detect-b32", (32, 20, 20, 64, 64, 3), ConvPlan(True, 64, 64, 1, True, True)),
    ("detect-b32", (32, 20, 20, 128, 128, 3), ConvPlan(True, 64, 64, 1, True, True)),
    ("detect-b32", (32, 20, 20, 128, 256, 3), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-b32", (32, 20, 20, 256, 64, 3), ConvPlan(True, 64, 64, 1, True, True)),
    ("detect-b32", (32, 20, 20, 256, 128, 1), ConvPlan(True, 128, 64, 1, False, False)),
    ("detect-b32", (32, 20, 20, 512, 256, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-b32", (32, 40, 40, 64, 1, 1), ConvPlan(False, 64, 16, 1, False, False)),
    ("detect-b32", (32, 40, 40, 64, 64, 1), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-b32", (32, 40, 40, 64, 64, 3), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-b32", (32, 40, 40, 64, 128, 3), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-b32", (32, 40, 40, 128, 64, 3), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-b32", (32, 40, 40, 128, 128, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-b32", (32, 40, 40, 256, 128, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-b32", (32, 80, 80, 32, 32, 3), ConvPlan(True, 64, 32, 1, False, False)),
    ("detect-b32", (32, 80, 80, 32, 64, 3), ConvPlan(True, 64, 64, 1, True, False)),
    ("detect-b32", (32, 80, 80, 64, 1, 1), ConvPlan(False, 64, 16, 1, False, False)),
    ("detect-b32", (32, 80, 80, 64, 64, 1), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-b32", (32, 80, 80, 64, 64, 3), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-b32", (32, 80, 80, 128, 64, 1), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-b32", (32, 160, 160, 16, 32, 3), ConvPlan(True, 64, 32, 1, False, False)),
    ("detect-b32", (32, 320, 320, 3, 16, 3), ConvPlan(False, 64, 16, 1, False, False)),
    ("detect-yolo12l-b32", (32, 32, 32, 64, 64, 1), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-yolo12l-b32", (32, 32, 32, 64, 64, 3), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-yolo12l-b32", (32, 32, 32, 128, 128, 3), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 32, 32, 256, 1, 1), ConvPlan(False, 128, 16, 1, False, False)),
    ("detect-yolo12l-b32", (32, 32, 32, 256, 128, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 32, 32, 256, 256, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 32, 32, 256, 307, 1), ConvPlan(False, 64, 64, 1, False, False)),
    ("detect-yolo12l-b32", (32, 32, 32, 256, 768, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 32, 32, 307, 256, 1), ConvPlan(False, 64, 64, 1, False, False)),
    ("detect-yolo12l-b32", (32, 32, 32, 512, 64, 3), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-yolo12l-b32", (32, 32, 32, 512, 256, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 32, 32, 512, 512, 3), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 32, 32, 1024, 512, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 32, 32, 1280, 512, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 64, 64, 1), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 64, 64, 3), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 128, 128, 3), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 256, 1, 1), ConvPlan(False, 64, 16, 1, False, False)),
    ("detect-yolo12l-b32", (32, 64, 64, 256, 128, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 256, 256, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 256, 256, 3), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 256, 307, 1), ConvPlan(False, 64, 64, 1, False, False)),
    ("detect-yolo12l-b32", (32, 64, 64, 256, 768, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 307, 256, 1), ConvPlan(False, 64, 64, 1, False, False)),
    ("detect-yolo12l-b32", (32, 64, 64, 512, 64, 3), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 512, 256, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 512, 512, 3), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 768, 256, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 768, 512, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 1024, 256, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 64, 64, 1280, 512, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 128, 128, 64, 64, 1), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-yolo12l-b32", (32, 128, 128, 64, 64, 3), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-yolo12l-b32", (32, 128, 128, 128, 64, 1), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-yolo12l-b32", (32, 128, 128, 128, 128, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 128, 128, 256, 1, 1), ConvPlan(False, 64, 16, 1, False, False)),
    ("detect-yolo12l-b32", (32, 128, 128, 256, 64, 3), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-yolo12l-b32", (32, 128, 128, 256, 256, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 128, 128, 256, 256, 3), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 128, 128, 384, 256, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 128, 128, 512, 512, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 128, 128, 1024, 128, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 256, 256, 32, 32, 3), ConvPlan(True, 64, 32, 1, False, False)),
    ("detect-yolo12l-b32", (32, 256, 256, 64, 32, 1), ConvPlan(True, 64, 32, 1, False, False)),
    ("detect-yolo12l-b32", (32, 256, 256, 64, 64, 1), ConvPlan(True, 128, 64, 1, True, True)),
    ("detect-yolo12l-b32", (32, 256, 256, 64, 128, 3), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 256, 256, 128, 128, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 256, 256, 256, 256, 1), ConvPlan(True, 128, 128, 1, True, True)),
    ("detect-yolo12l-b32", (32, 512, 512, 3, 64, 3), ConvPlan(False, 64, 64, 1, False, False)),
    ("detect-b32", (32, 20, 20, 256, 128, 256), C2fPlan(8, 1, True)),
    ("detect-b32", (32, 20, 20, 384, 128, 256), C2fPlan(8, 1, True)),
    ("detect-b32", (32, 40, 40, 192, 64, 128), C2fPlan(8, 1, True)),
    ("detect-b32", (32, 40, 40, 384, 64, 128), C2fPlan(8, 1, True)),
    ("detect-b32", (32, 80, 80, 192, 32, 64), C2fPlan(8, 1, True)),
    ("detect-b32", (32, 160, 160, 32, 16, 32), C2fPlan(8, 1, True)),
]


def _raster_fits(shape, p):
    side_y, side_x = shape[3], shape[4]
    limit = rf.TWO_BLOCKS_SMEM if p.threads == 512 else rf.MAX_SMEM
    return (p.threads in (512, 1024) and p.bands == rf.fewest_bands(side_y, side_x, p.threads) > 0
            and p.smem_bytes == rf.smem_bytes(side_y, side_x, p.threads, p.bands) <= limit)


def _conv_fits(shape, p):
    """What `csrc/conv.cu`'s entry takes, in a block's shared memory."""
    cin, cout = shape[3], shape[4]
    if (p.vec and (cin % 8 or cout % 8)) or conv.smem_bytes(p, True) > conv.SMEM_LIMIT:
        return False
    if p.tma:
        return p.vec and p.split == 1 and cin % 64 == 0 and cout % p.bn == 0 and (p.bm, p.bn) in TMA_TILES
    if p.wgmma:
        return p.vec and p.split == 1 and p.bn == 64 and cout % 64 == 0 and p.bm in (64, 128)
    return p.bn == conv.width(cout) and p.bm in conv.BF16_ROWS[p.bn] and p.split in conv.SPLITS


TMA_TILES = ((64, 64), (128, 64), (128, 128))


def _c2f_fits(shape, p):
    cin, c, feat = shape[3:6]
    return (p.tile in c2f.TILES and p.cluster in c2f.CLUSTERS and c2f.cluster_fits(c, feat, p.cluster)
            and (not p.vec or cin % 8 == c % 8 == feat % 8 == 0)
            and c2f.smem_bytes(c, p.tile, p.cluster, True, p.vec) <= 227 * 1024)


# by the pick's type: the planner, its layouts and the fit test, each taking the shape
KERNELS = {
    IcpPlan: (lambda *a: k1.icp_plan(*a, CARD), lambda *a: k1.layouts(*a, CARD),
              lambda shape, p: k1.plan_fits(*shape, CARD, p.row_groups, p.slices, p.cluster)),
    NnPlan: (nn.nn_plan, nn.layouts, lambda shape, p: p.lanes in nn.LANES and p.cluster in nn.CLUSTERS),
    RasterPlan: (lambda *a: rf.raster_plan(*a, in_place=True), lambda *a: rf.layouts(*a, in_place=True),
                 _raster_fits),
    ConvPlan: (lambda *a: conv.conv_plan(*a, True), lambda *a: conv.layouts(*a, True), _conv_fits),
    C2fPlan: (lambda *a: c2f.c2f_plan(*a, True), lambda *a: c2f.layouts(*a, True), _c2f_fits),
}
IDS = [f"{cell}-{type(pick).__name__}-{'x'.join(map(str, shape))}" for cell, shape, pick in PICKS]


@pytest.mark.parametrize("cell,shape,pick", PICKS, ids=IDS)
def test_planners_pick_the_pinned_layout(cell, shape, pick):
    planner, _, _ = KERNELS[type(pick)]
    assert planner(*shape) == pick


@pytest.mark.parametrize("cell,shape,pick", PICKS, ids=IDS)
def test_layouts_hold_the_pick_and_every_layout_fits(cell, shape, pick):
    planner, layouts, fits = KERNELS[type(pick)]
    listed = layouts(*shape)
    assert planner(*shape) in listed and len(set(listed)) == len(listed) > 0
    assert all(fits(shape, p) for p in listed)
