"""K5-K7 (conv + bias + SiLU): the port's plain versions against the JAX
Pallas kernels in interpret mode (they pick it themselves on the CPU).

Tolerances: float32 3e-4 (order of summation; the JAX package's own tests
use 2e-4 and 3e-4), bfloat16 0.05 as `tests/test_conv_fused.py` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu.ops.pallas import conv_fused as jconv
from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import conv_fused as tconv

torch.set_num_threads(2)

F32, BF16 = (jnp.float32, torch.float32, 3e-4), (jnp.bfloat16, torch.bfloat16, 0.05)


def _inputs(seed, x_shape, w_shape, jdt, tdt):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal(x_shape), rng.standard_normal(w_shape) * 0.1, rng.standard_normal(w_shape[-1]) * 0.1)
    j = [jnp.asarray(a, jnp.float32).astype(jdt) for a in arrs]
    # the same rounded values on both sides
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in j]
    return j, t


def _close(got: torch.Tensor, want, tol):
    assert got.dtype in (torch.float32, torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("types", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 32), (16, 48)])
def test_conv1x1_matches_pallas_interpret(cin, cout, types):
    jdt, tdt, tol = types
    (jx, jw, jb), (tx, tw, tb) = _inputs(cin + cout, (2, 16, 16, cin), (cin, cout), jdt, tdt)
    _close(tconv.conv1x1_silu(tx, tw, tb), jconv.conv1x1_silu(jx, jw, jb, tile_m=128), tol)


@pytest.mark.parametrize("types", [F32, BF16], ids=["f32", "bf16"])
def test_conv1x1_no_act_one_output_channel(types):
    """The class head's shape: 64 -> 1 without activation."""
    jdt, tdt, tol = types
    (jx, jw, jb), (tx, tw, tb) = _inputs(4, (1, 8, 32, 64), (64, 1), jdt, tdt)
    got = tconv.conv1x1_silu(tx, tw, tb, act=False)
    assert got.shape == (1, 8, 32, 1)
    _close(got, jconv.conv1x1_silu(jx, jw, jb, tile_m=64, act=False), tol)


@pytest.mark.parametrize("types", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,h,w", [(32, 32, 16, 16), (16, 32, 8, 32), (64, 64, 16, 16), (16, 16, 4, 8)])
def test_conv3x3_matches_pallas_interpret(cin, cout, h, w, types):
    """The last case is a single row tile."""
    jdt, tdt, tol = types
    (jx, jw, jb), (tx, tw, tb) = _inputs(cin + h, (2, h, w, cin), (3, 3, cin, cout), jdt, tdt)
    _close(tconv.conv3x3_silu(tx, tw, tb), jconv.conv3x3_silu(jx, jw, jb, tile_h=8), tol)


@pytest.mark.parametrize("types", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,h,w", [(3, 16, 32, 32), (16, 32, 32, 32), (64, 128, 16, 16), (3, 16, 8, 64)])
def test_conv3x3s2_matches_pallas_interpret(cin, cout, h, w, types):
    """Cin = 3 is the stem; the last case is a single row tile."""
    jdt, tdt, tol = types
    (jx, jw, jb), (tx, tw, tb) = _inputs(cin + cout, (2, h, w, cin), (3, 3, cin, cout), jdt, tdt)
    got = tconv.conv3x3s2_silu(tx, tw, tb)
    assert got.shape == (2, h // 2, w // 2, cout)
    _close(got, jconv.conv3x3s2_silu(jx, jw, jb, tile_h=4), tol)


def _xla_conv(x, w, b, stride, act):
    y = jax.lax.conv_general_dilated(x, w, (stride, stride), [(w.shape[0] // 2,) * 2] * 2,
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y = y + b
    return jax.nn.silu(y) if act else y


@pytest.mark.parametrize("k,stride,cin,cout,h,w,act", [
    (1, 1, 5, 7, 9, 11, True), (1, 1, 192, 3, 5, 5, False), (3, 1, 5, 7, 9, 11, True), (3, 1, 384, 8, 3, 5, True),
    (3, 2, 5, 7, 10, 6, True), (3, 2, 3, 1, 2, 2, True)])
def test_shapes_the_jax_kernels_refuse(k, stride, cin, cout, h, w, act):
    """The port takes every shape (the JAX kernels' packing conditions go
    with the packing): held against XLA's conv, float32 at 3e-4.  Stride 2
    puts the window of output (i, j) at input rows 2i-1..2i+1."""
    (jx, jw, jb), (tx, tw, tb) = _inputs(k * cin + h, (3, h, w, cin), (k, k, cin, cout), jnp.float32, torch.float32)
    if k == 1:
        got = tconv.conv1x1_silu(tx, tw[0, 0], tb, act=act)
    else:
        got = (tconv.conv3x3s2_silu if stride == 2 else tconv.conv3x3_silu)(tx, tw, tb)
    _close(got, _xla_conv(jx, jw, jb, stride, act), 3e-4)


def test_wrappers_raise_on_what_the_kernel_does_not_take():
    x, w, b = torch.zeros(1, 5, 4, 8), torch.zeros(3, 3, 8, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="even"):
        tconv.conv3x3s2_silu(x, w, b)
    with pytest.raises(TypeError):
        tconv.conv3x3_silu(x.double(), w.double(), b.double())
    with pytest.raises(TypeError):
        tconv.conv3x3_silu(x, w.bfloat16(), b)
    with pytest.raises(ValueError, match="contiguous"):
        tconv.conv3x3_silu(torch.zeros(1, 5, 8, 4).transpose(2, 3), w, b)
    with pytest.raises(ValueError):
        tconv.conv1x1_silu(x, w, b)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = dict(pallas.LAUNCHES)
    x, w, b = torch.randn(1, 4, 4, 8), torch.randn(3, 3, 8, 8), torch.randn(8)
    assert torch.equal(tconv.conv3x3_silu(x, w, b), tconv.conv_bias_act_plain(x, w, b, 1, True))
    assert pallas.LAUNCHES == before


# -- the variant the wrapper picks (`conv_plan`): the same choice the card gets

SITES = [  # (Cin, Cout, H = W of the output, k): every K5-K7 site of a yolo-n forward at 640 px
    (64, 64, 80, 1), (128, 64, 80, 1), (128, 128, 40, 1), (256, 128, 40, 1), (256, 128, 20, 1), (512, 256, 20, 1),
    (64, 1, 80, 1), (64, 64, 40, 1), (64, 1, 20, 1),
    (32, 32, 80, 3), (64, 64, 40, 3), (64, 64, 80, 3), (128, 64, 40, 3), (256, 64, 20, 3), (64, 64, 20, 3),
    (3, 16, 320, 3), (16, 32, 160, 3), (32, 64, 80, 3), (64, 128, 40, 3), (128, 256, 20, 3), (64, 64, 40, 3)]


def _check_plan(plan, bsz, ho, wo, cin, cout, k, bf16):
    assert tconv.smem_bytes(plan, bf16) <= tconv.SMEM_LIMIT
    if plan.wgmma:
        assert bf16 and plan.vec and plan.split == 1 and cout % 64 == 0 and plan.tma == (cin % 64 == 0)
        if plan.tma:  # 128 rows (BN 128 where Cout allows) where they fill the card, else 64 x 64
            tiles = -(-bsz * ho * wo // 128) * (cout // (128 if cout % 128 == 0 else 64))
            assert (plan.bm, plan.bn) == ((128, 128 if cout % 128 == 0 else 64) if tiles >= 132 else (64, 64))
        else:  # the 64-row warpgroup kernel: one or two warpgroups, 64 columns
            assert plan.bm in (64, 128) and plan.bn == 64
        return
    assert not plan.tma
    assert plan.bn in (16, 32, 64) and plan.bn == tconv.width(cout)
    if not bf16:
        assert (plan.vec, plan.split, plan.bm * plan.bn) == (False, 1, 4096)
        return
    assert plan.bm in tconv.BF16_ROWS[plan.bn] and plan.split in tconv.SPLITS and plan.bm % plan.split == 0
    assert plan.vec == (cin % 8 == 0 and cout % 8 == 0)
    if plan.split > 1:  # every block of the cluster keeps a 64-value block of the K axis or more
        assert -(-k * k * cin // tconv.GROUP_UNIT) >= plan.split


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("bsz", [1, 2, 8, 32])
def test_conv_plan_is_valid_at_every_site(bsz, bf16):
    for cin, cout, ho, k in SITES:
        _check_plan(tconv.conv_plan(bsz, ho, ho, cin, cout, k, bf16), bsz, ho, ho, cin, cout, k, bf16)


def test_conv_plan_fills_the_card_at_small_maps():
    """At batch 1 and 2 every site gets about 1.5 blocks per SM: where its
    rows alone do not, the K axis is split over a cluster, up to the most
    blocks the K axis allows, unless it is a 3x3 that the TMA-fed loop takes
    on 64 x 64 tiles for a third of the SMs or more; a 1x1 of at most 128
    channels is never split; the 16-byte gather is taken at every site but
    the stem and the class head."""
    for bsz in (1, 2):
        for cin, cout, ho, k in SITES:
            plan = tconv.conv_plan(bsz, ho, ho, cin, cout, k, True)
            blocks = -(-bsz * ho * ho // plan.bm) * -(-cout // plan.bn) * plan.split
            units = -(-k * k * cin // tconv.GROUP_UNIT)
            assert plan.vec == (cin != 3 and cout != 1)
            if plan.tma and plan.bm == 64:
                assert k == 3 and 3 * blocks >= 132
            elif units <= 2:
                assert plan.split == 1
            else:
                assert blocks >= 1.5 * 132 or plan.split == max(s for s in tconv.SPLITS if s <= units)
    assert tconv.conv_plan(2, 20, 20, 256, 64, 3, True) == tconv.ConvPlan(True, 32, 64, 8)
    assert tconv.conv_plan(2, 20, 20, 64, 64, 3, True) == tconv.ConvPlan(True, 32, 64, 8)  # 13 tiles: split
    assert tconv.conv_plan(2, 40, 40, 64, 64, 3, True) == tconv.ConvPlan(True, 64, 64, 1, True, True)  # 50 tiles
    # a 3x3 of Cin and Cout multiples of 64 takes the TMA-fed loop, on 64 rows where 128-row tiles would not
    # fill the card; any such site whose 128-row tiles fill it takes them
    assert tconv.conv_plan(1, 80, 80, 64, 64, 3, True) == tconv.ConvPlan(True, 64, 64, 1, True, True)  # 100 tiles
    assert tconv.conv_plan(2, 80, 80, 64, 64, 3, True) == tconv.ConvPlan(True, 64, 64, 1, True, True)
    assert tconv.conv_plan(8, 80, 80, 64, 64, 3, True) == tconv.ConvPlan(True, 128, 64, 1, True, True)
    assert tconv.conv_plan(32, 80, 80, 64, 64, 3, True) == tconv.ConvPlan(True, 128, 64, 1, True, True)
    assert tconv.conv_plan(8, 80, 80, 64, 64, 1, True) == tconv.ConvPlan(True, 128, 64, 1, True, True)
    # Cin 32: the 64-row warpgroup kernel, which gathers with its own threads
    assert tconv.conv_plan(8, 80, 80, 32, 64, 3, True) == tconv.ConvPlan(True, 128, 64, 1, True, False)
    assert tconv.conv_plan(2, 80, 80, 32, 64, 3, True) == tconv.ConvPlan(True, 64, 64, 1, True, False)
    assert not tconv.conv_plan(2, 80, 80, 64, 64, 1, True).wgmma  # 100 tiles of 128 rows: mma.sync


def test_every_shape_takes_some_variant():
    rng = np.random.default_rng(3)
    for _ in range(400):
        cin, cout = int(rng.integers(1, 600)), int(rng.integers(1, 300))
        bsz, ho, wo, k = int(rng.integers(1, 40)), int(rng.integers(1, 200)), int(rng.integers(1, 200)), int(rng.choice([1, 3]))
        for bf16 in (True, False):
            _check_plan(tconv.conv_plan(bsz, ho, wo, cin, cout, k, bf16), bsz, ho, wo, cin, cout, k, bf16)


def test_forced_variants_are_checked_and_run_the_plain_version_on_cpu():
    """Every layout of `layouts` runs the plain version on the CPU (the
    gathers, every tile and split); a plan that is not one of them raises:
    the 16-byte gather at Cin 3, a split of 3, a split in float32, the
    warpgroup products at Cout 8."""
    x, w, b = (torch.randn(2, 6, 6, 16).bfloat16(), (torch.randn(3, 3, 16, 8) * 0.1).bfloat16(),
               torch.randn(8).bfloat16())
    want = tconv.conv_bias_act_plain(x, w, b, 1, True)
    listed = tconv.layouts(2, 6, 6, 16, 8, 3, True)
    assert {(p.vec, p.split) for p in listed} == {(v, s) for v in (True, False) for s in tconv.SPLITS}
    for plan in listed:
        assert torch.equal(tconv.conv3x3_silu(x, w, b, plan=plan), want)
    with pytest.raises(ValueError, match="no layout"):
        tconv.conv3x3s2_silu(torch.zeros(1, 4, 4, 3).bfloat16(), torch.zeros(3, 3, 3, 16).bfloat16(),
                             torch.zeros(16).bfloat16(), plan=tconv.ConvPlan(True, 64, 16, 1))
    with pytest.raises(ValueError, match="no layout"):
        tconv.conv3x3_silu(x, w, b, plan=tconv.ConvPlan(True, 64, 16, 3))
    with pytest.raises(ValueError, match="no layout"):
        tconv.conv1x1_silu(x.float(), w[1, 1].float(), b.float(), plan=tconv.ConvPlan(False, 256, 16, 2))
    with pytest.raises(ValueError, match="no layout"):  # Cout 8 is no multiple of 64
        tconv.conv3x3_silu(x, w, b, plan=tconv.ConvPlan(True, 64, 64, 1, True))


@pytest.mark.parametrize("cin,cout,vec,split", [(64, 8, None, None), (64, 96, None, None), (32, 96, None, None),
                                                (307, 256, None, None), (64, 64, False, None), (64, 64, None, 2),
                                                (256, 768, None, 4)])
def test_forcing_wgmma_raises_where_it_cannot_run(cin, cout, vec, split):
    """Warpgroup products take Cout a multiple of 64, the 16-byte gather's
    operands and no split: `layouts` lists none elsewhere, and a plan of
    them there raises.  Cin a multiple of 64 has the TMA-fed loop too (its
    boxes are 64 channels and 64 columns wide), every other Cin the 64-row
    kernel alone."""
    plan = tconv.ConvPlan(vec is not False, 128, 64, split or 1, True, cin % 64 == 0)
    assert plan not in tconv.layouts(32, 64, 64, cin, cout, 1, True)
    x, w, b = (torch.zeros(1, 2, 2, cin).bfloat16(), torch.zeros(cin, cout).bfloat16(), torch.zeros(cout).bfloat16())
    with pytest.raises(ValueError, match="no layout"):
        tconv.conv1x1_silu(x, w, b, plan=plan)
    if vec is None and split is None and cin % 8 == 0:
        wide = [p for p in tconv.layouts(32, 64, 64, cin, 64, 1, True) if p.wgmma]
        assert {p.tma for p in wide} == {False, cin % 64 == 0}


@pytest.mark.parametrize("bsz,ho,cin,cout,k", [(8, 80, 64, 64, 3), (32, 80, 64, 64, 3), (1, 20, 256, 64, 3),
                                               (8, 40, 64, 128, 3), (2, 80, 128, 64, 1), (32, 64, 256, 768, 1),
                                               (32, 64, 512, 512, 3), (32, 32, 1280, 512, 1)])
def test_wgmma_plan(bsz, ho, cin, cout, k):
    """The TMA-fed warpgroup loop's layouts: 128 rows (two consumer
    warpgroups) with BN 128 where Cout is a multiple of 128, 128 x 64, and
    64 x 64; no split, the 16-byte gather; their shared memory fits.  The
    plan takes the widest 128-row one when its tiles fill the card's 132 SMs
    once or more, else 64 x 64, wherever it takes the loop.  A split of the
    loop raises."""
    loop = [p for p in tconv.layouts(bsz, ho, ho, cin, cout, k, True) if p.tma]
    assert [(p.bm, p.bn) for p in loop] == [(128, 128)] * (cout % 128 == 0) + [(128, 64), (64, 64)]
    assert all(p.wgmma and p.vec and p.split == 1 and tconv.smem_bytes(p, True) <= tconv.SMEM_LIMIT for p in loop)
    tiles = -(-bsz * ho * ho // 128) * (cout // (128 if cout % 128 == 0 else 64))
    taken = loop[0] if tiles >= 132 else loop[-1]
    assert (taken.bm, taken.bn) == ((128, 128 if cout % 128 == 0 else 64) if tiles >= 132 else (64, 64))
    plan = tconv.conv_plan(bsz, ho, ho, cin, cout, k, True)
    assert not plan.tma or plan == taken
    x, w, b = (torch.zeros(1, 2, 2, cin).bfloat16(), torch.zeros(k, k, cin, cout).bfloat16(),
               torch.zeros(cout).bfloat16())
    split = tconv.ConvPlan(True, taken.bm, taken.bn, 2, True, True)
    with pytest.raises(ValueError):
        tconv.conv3x3_silu(x, w, b, plan=split) if k == 3 else tconv.conv1x1_silu(x, w[0, 0], b, plan=split)


def test_yolo12l_sites_take_the_warpgroup_loop():
    """At the cell's shapes (YOLO12-L, one class, 1024 px, batch 32) every
    K5-K7 site with Cin and Cout multiples of 64 takes the TMA-fed loop on
    128-row tiles: the 50 3x3s that took the 64-row warpgroup kernel before
    it, the 88 1x1s that took `mma.sync` on 64 x 64 tiles, and three sites at
    32 x 32 (141 of the forward's 189 launches).  The 307-channel MLP sites,
    the 32-channel C3k sites, the stem and the class head do not."""
    from portbench.reference import yolo12

    cfg = {"variant": "l", "num_classes": 1, "reg_max": 16, "bn_eps": 1e-3}
    taken = {1: 0, 3: 0}
    sites = [s for s in yolo12.site_work(cfg, 1024) if s["kernel"]]
    for s in sites:
        plan = tconv.conv_plan(32, s["hw_out"], s["hw_out"], s["cin"], s["cout"], s["k"], True)
        _check_plan(plan, 32, s["hw_out"], s["hw_out"], s["cin"], s["cout"], s["k"], True)
        wide = s["cin"] % 64 == 0 and s["cout"] % 64 == 0
        assert plan.wgmma == plan.tma == wide and (not wide or plan.bm == 128), s["site"]
        if s["cin"] == 307 or s["cout"] in (307, 32, 1) or s["cin"] == 3:
            assert not plan.wgmma, s["site"]
        taken[s["k"]] += plan.tma
    assert len(sites) == 189 and taken == {1: 89, 3: 52}


def test_every_fused_kernel_is_read_by_the_roofline_share():
    """Every `__global__` kernel of `csrc/conv.cu` and `csrc/c2f.cu` has a
    name that `conv_roofline_share` counts, so the metric's time is all of
    K5-K8's and its share cannot read over 100 % for a kernel it misses."""
    import os
    import re

    from portbench.metrics.conv_roofline_share import _FUSED

    csrc = os.path.join(os.path.dirname(tconv.__file__), "..", "..", "csrc")
    names = []
    for source in ("conv.cu", "c2f.cu"):
        with open(os.path.join(csrc, source)) as f:
            names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(",
                                f.read())
    assert len(names) >= 4 and all(_FUSED.search(n) for n in names), names
