"""K8 (the whole C2f block): the port's plain version against the JAX Pallas
kernel in interpret mode, float32 at 3e-4 (order of summation; the JAX
package's own test uses 3e-4) and bfloat16 at 0.05 (a few bfloat16 steps of
outputs of magnitude ~2; both sides round a, b, t1 and p at the same points)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_slam_yolo_tpu.ops.pallas import c2f_fused as jc2f
from icp_slam_yolo_tpu_torch.ops import pallas
from icp_slam_yolo_tpu_torch.ops.pallas import c2f_fused as tc2f

torch.set_num_threads(2)


def _case(seed, bsz, h, w, cin, c, feat, jdt, tdt):
    rng = np.random.default_rng(seed)
    shapes = [(bsz, h, w, cin), (cin, 2 * c), (2 * c,), (3, 3, c, c), (c,), (3, 3, c, c), (c,), (3 * c, feat), (feat,)]
    arrs = [rng.standard_normal(s) * (1.0 if i == 0 else 0.1) for i, s in enumerate(shapes)]
    j = [jnp.asarray(a, jnp.float32).astype(jdt) for a in arrs]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in j]
    # weights and x in the working type; the port's biases are float32
    t = [a.to(tdt) if a.dim() != 1 else a for a in t]
    return j, t


@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, 3e-4), (jnp.bfloat16, torch.bfloat16, 0.05)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,c,feat,h,w,shortcut", [
    (32, 16, 32, 32, 32, True), (64, 32, 64, 16, 16, True), (32, 16, 32, 8, 16, True),   # the last: one row tile
    (96, 32, 64, 16, 16, False), (48, 16, 32, 8, 8, False)])
def test_c2f_matches_pallas_interpret(cin, c, feat, h, w, shortcut, jdt, tdt, tol):
    j, t = _case(cin + h, 2, h, w, cin, c, feat, jdt, tdt)
    want = jc2f.c2f_fused(*j, tile_h=8, shortcut=shortcut)
    got = tc2f.c2f_fused(*t, shortcut=shortcut)
    assert got.dtype == tdt and got.shape == (2, h, w, feat)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


def _xla_c2f(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, shortcut):
    def conv3(v, w, b):
        y = jax.lax.conv_general_dilated(v, w, (1, 1), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jax.nn.silu(y + b)

    c = w1.shape[1] // 2
    y = jax.nn.silu(jnp.einsum("bhwc,co->bhwo", x, w1) + b1)
    a, b = y[..., :c], y[..., c:]
    t2 = conv3(conv3(b, wm1, bm1), wm2, bm2)
    p = b + t2 if shortcut else t2
    return jax.nn.silu(jnp.einsum("bhwc,co->bhwo", jnp.concatenate([a, b, p], -1), w2) + b2)


@pytest.mark.parametrize("cin,c,feat,h,w,shortcut", [(24, 8, 20, 13, 11, True), (7, 5, 3, 4, 4, False),
                                                    (384, 12, 16, 5, 3, True)])
def test_shapes_the_jax_kernel_refuses(cin, c, feat, h, w, shortcut):
    """Any width, height and channel count: held against the op-by-op XLA
    forward in float32 at 3e-4.  The intermediates' zero padding is
    `F.conv2d`'s own here, so a border error would show."""
    j, t = _case(h * w, 2, h, w, cin, c, feat, jnp.float32, torch.float32)
    got = tc2f.c2f_fused(*t, shortcut=shortcut)
    np.testing.assert_allclose(got.numpy(), np.asarray(_xla_c2f(*j, shortcut)), rtol=3e-4, atol=3e-4)


def test_bf16_rounding_points():
    """The bfloat16 plain version rounds a, b, t1 and p only and returns
    bfloat16; it agrees with the float32 composition of the same (bfloat16
    valued) operands to bfloat16 accuracy."""
    _, t = _case(5, 1, 8, 8, 32, 16, 32, jnp.bfloat16, torch.bfloat16)
    got = tc2f.c2f_fused_plain(*t, shortcut=True).float()
    ref = tc2f.c2f_fused_plain(*[a.float() for a in t], shortcut=True)
    assert float((got - ref).abs().max()) < 0.05
    assert tc2f.c2f_fused_plain(*t).dtype == torch.bfloat16


def test_wrapper_checks_and_counts_no_launch_on_cpu():
    _, t = _case(1, 1, 4, 4, 8, 4, 8, jnp.float32, torch.float32)
    before = dict(pallas.LAUNCHES)
    assert torch.equal(tc2f.c2f_fused(*t), tc2f.c2f_fused_plain(*t))
    assert pallas.LAUNCHES == before
    with pytest.raises(TypeError):  # biases must be float32
        tc2f.c2f_fused(*[a.bfloat16() for a in t])
    with pytest.raises(ValueError):  # w2 must take 3c channels
        tc2f.c2f_fused(*t[:7], t[7][:8], t[8])


# -- the variant the wrapper picks (`c2f_plan`): the same choice the card gets

SITES = [(32, 16, 32, 160), (256, 128, 256, 20), (384, 64, 128, 40), (192, 32, 64, 80), (192, 64, 128, 40),
         (384, 128, 256, 20)]  # (Cin, c, F, H = W): the six C2f blocks of a yolo-n forward at 640 px


def _check_plan(plan, cin, c, feat, bf16):
    assert plan.tile in tc2f.TILES and plan.cluster in tc2f.CLUSTERS
    assert tc2f.cluster_fits(c, feat, plan.cluster) and (bf16 or plan.cluster == 1)
    assert tc2f.smem_bytes(c, plan.tile, plan.cluster, bf16, plan.vec) <= 227 * 1024
    assert plan.vec == (bf16 and cin % 8 == 0 and c % 8 == 0 and feat % 8 == 0)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("bsz", [1, 2, 8, 32])
def test_c2f_plan_is_valid_at_every_site(bsz, bf16):
    for cin, c, feat, h in SITES:
        plan = tc2f.c2f_plan(bsz, h, h, cin, c, feat, bf16)
        _check_plan(plan, cin, c, feat, bf16)
        if bf16:  # the cluster grows only while the tiles leave SMs idle
            tiles = bsz * -(-h // plan.tile) ** 2
            assert plan.cluster == 1 or tiles * plan.cluster // 2 < 132


def test_every_c2f_shape_takes_some_variant():
    rng = np.random.default_rng(4)
    for _ in range(300):
        cin, c, feat = int(rng.integers(1, 400)), int(rng.integers(1, 140)), int(rng.integers(1, 300))
        bsz, h, w = int(rng.integers(1, 9)), int(rng.integers(1, 90)), int(rng.integers(1, 90))
        for bf16 in (True, False):
            _check_plan(tc2f.c2f_plan(bsz, h, w, cin, c, feat, bf16), cin, c, feat, bf16)


def test_c2f_shared_memory_by_hand():
    """c = 128 at an 8 x 8 tile, bfloat16: y 144 rows of 264 values, t1 100
    and p 64 rows of 136 (x's ring, 3 x 144 rows of 40, overlays them), W's
    ring 3 x 64 rows of 72 with the 16-byte copies (3 x 32 with scalar
    loads), a table of 144 ints.  A cluster of 4 narrows the passes of
    stages 2 and 3 to 32 columns, but stages 1 and 4 keep 64, and the ring
    holds those.  At c = 16 x's ring is the larger of the two, and W's rows
    are 32 + 8 wide."""
    y, t1p, xr, wr, tab = 144 * 264 * 2, (100 + 64) * 136 * 2, 3 * 144 * 40 * 2, 3 * 64 * 72 * 2, 144 * 4
    assert t1p > xr
    assert tc2f.smem_bytes(128, 8, 1, True, True) == y + t1p + wr + tab
    assert tc2f.smem_bytes(128, 8, 1, True, False) == y + t1p + 3 * 32 * 72 * 2 + tab
    assert tc2f.smem_bytes(128, 8, 4, True, True) == y + t1p + wr + tab
    assert tc2f.smem_bytes(16, 8, 1, True, True) == 144 * 40 * 2 + xr + 3 * 64 * 40 * 2 + tab
    assert tc2f.smem_bytes(128, 8, 1, False, False) > 227 * 1024  # float32 keeps everything in float32: 4 x 4 there


def test_forced_c2f_variants_are_checked():
    """Every layout of `layouts` runs the plain version on the CPU (every
    tile, both gathers; 8 channels of t1 split over no cluster in 16-byte
    units); a plan that is not one of them raises: a cluster of 4, a tile of 3, the 16-byte copies
    at odd channels, a cluster in float32."""
    _, t = _case(2, 1, 6, 6, 16, 8, 16, jnp.bfloat16, torch.bfloat16)
    want = tc2f.c2f_fused_plain(*t)
    listed = tc2f.layouts(2, 6, 6, 16, 8, 16, True)
    assert {(p.tile, p.cluster, p.vec) for p in listed} == {(t_, 1, v) for t_ in tc2f.TILES for v in (True, False)}
    for plan in listed:
        assert torch.equal(tc2f.c2f_fused(*t, plan=plan), want)
    with pytest.raises(ValueError, match="no layout"):
        tc2f.c2f_fused(*t, plan=tc2f.C2fPlan(8, 4, True))
    with pytest.raises(ValueError, match="no layout"):
        tc2f.c2f_fused(*t, plan=tc2f.C2fPlan(3, 1, True))
    _, odd = _case(3, 1, 4, 4, 7, 5, 3, jnp.bfloat16, torch.bfloat16)
    with pytest.raises(ValueError, match="no layout"):
        tc2f.c2f_fused(*odd, plan=tc2f.C2fPlan(4, 1, True))
    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in t]
    with pytest.raises(ValueError, match="no layout"):
        tc2f.c2f_fused(*f32, plan=tc2f.C2fPlan(8, 2, False))
