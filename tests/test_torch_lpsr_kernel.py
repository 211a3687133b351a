"""K2, the LPSR stage as one kernel: the port's packer and plain version
against the JAX package's kernel (interpret mode) and reference, the
wrapper's dispatch and work count, and (on a card) the CUDA kernel against
the plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpr_tpu.models.lpsr import LPSRConfig, lpsr_apply, lpsr_init
from lpr_tpu.ops.pallas.lpsr_kernel import lpsr_pallas
from lpr_tpu.weights.checkpoint import load_params
from lpr_tpu_torch.kernels import lpsr as kl
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.weights.checkpoint import params_from_jax

from .torch_ref import LPSR

CFG = LPSRConfig()


@pytest.fixture(scope="module")
def jax_params():
    """lpsr_init's random weights, and the real checkpoint loaded into the
    same pytree (as torch_ref.lpsr loads it, with one compile of init)."""
    rand = jax.jit(lambda k: lpsr_init(k, CFG))(jax.random.PRNGKey(0))
    return {"random": jax.device_get(rand),
            "real": jax.device_get(load_params(LPSR, rand))}


def _port(params):
    """The port's LPSR module on the same weights, carried across by
    params_from_jax, and its packed buffer."""
    model = tlpsr.LPSR(params_from_jax(params)).eval()
    return model, kl.lpsr_pack(model)


def _crops(n, seed):
    return np.random.RandomState(seed).rand(n, 32, 192, 3).astype(np.float32)


@pytest.mark.parametrize("weights", ["random", "real"])
def test_lpsr_plain_bf16_matches_jax_kernel(jax_params, weights):
    """lpsr_plain in bf16 vs lpsr_pallas (interpret mode, bf16 activations,
    float32 weights) on two crops.  Both round at the same points; they
    differ where float32 sums taken in another order round to neighbouring
    bf16 values (about half the outputs, by up to 8.2e-3 with the real
    weights; measured).  Bound: the JAX kernel test's 2e-2, and a mean of
    2e-3."""
    params = jax_params[weights]
    _, packed = _port(params)
    x = _crops(2, 1)
    ref = np.asarray(lpsr_pallas(params, jnp.asarray(x), CFG,
                                 interpret=True))
    got = kl.lpsr_plain(torch.from_numpy(x).to(torch.bfloat16), packed)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 192, 1)
    err = np.abs(got.numpy() - ref)
    assert err.max() < 2e-2, err.max()
    assert err.mean() < 2e-3, err.mean()


def test_lpsr_plain_fp32_matches_lpsr_apply_and_model(jax_params):
    """lpsr_plain in float32 vs lpsr_apply (JAX at 'highest') and vs the
    port's LPSR.forward, real weights: float32 rounding only (alpha folded
    into lff, sums in another order)."""
    params = jax_params["real"]
    model, packed = _port(params)
    x = _crops(2, 2)
    ref = np.asarray(jax.jit(lambda p, v: lpsr_apply(p, v, CFG))(
        params, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = kl.lpsr_plain(xt, packed).numpy()
    with torch.inference_mode():
        own = model(xt).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-5)


def test_lpsr_pack_layout_and_rejections():
    model = tlpsr.load_lpsr(LPSR, device="cpu")
    packed = kl.lpsr_pack(model)
    assert len(packed.offsets) == len(kl.PACK_KEYS) == 62
    assert all(o % 4 == 0 for o in packed.offsets)
    assert list(packed.offsets) == sorted(packed.offsets)
    assert packed.buf.dtype == torch.float32
    assert packed["ae.conv_in.w"].shape == (3, 3, 3, 12)
    assert packed["csar.fc1.w"].shape == (32, 8)
    alpha = float(model.rdbs[1].alpha)
    np.testing.assert_allclose(
        packed["rdb1.lff.b"].numpy(),
        model.rdbs[1].lff.b.numpy() * alpha, rtol=1e-6)
    with pytest.raises(ValueError):
        kl.lpsr_plain(torch.rand(1, 30, 192, 3), packed)


def test_wrapper_takes_plain_version_on_cpu():
    packed = kl.lpsr_pack(tlpsr.load_lpsr(LPSR, device="cpu"))
    x = torch.from_numpy(_crops(1, 3))
    before = kl.lpsr_fused.launches
    got = kl.lpsr_fused(x, packed)
    assert kl.lpsr_fused.launches == before       # no kernel launch
    np.testing.assert_array_equal(got.numpy(),
                                  kl.lpsr_plain(x, packed).numpy())
    with pytest.raises(ValueError):
        kl.lpsr_fused(x.to("meta"), packed)


def test_lpsr_work_at_the_production_shape():
    """917.3 M multiply-adds per 32x192 image, 44.0 GFLOP for the main
    path's N = 24; ~2.0 MB moved (bf16 input, float32 output, float32
    weights once)."""
    flops, nbytes = kl.lpsr_work(24, 32, 192)
    assert kl.lpsr_work(1, 32, 192)[0] == pytest.approx(2 * 917.3e6,
                                                        rel=1e-4)
    assert flops == pytest.approx(44.03e9, rel=1e-3)
    io = 24 * 32 * 192 * (3 * 2 + 4)
    assert 0 < nbytes - io < 6e5
    packed = kl.lpsr_pack(tlpsr.load_lpsr(LPSR, device="cpu"))
    n_weights = sum(int(np.prod(s)) for _, s in packed.entries.values())
    assert nbytes - io == 4 * n_weights


# K2's shapes on the card: the main path's, and ones where a block owns 0-1
# rows of the quarter grid, M is not a multiple of 16, the rows split into
# slabs (48 rows) or the columns do (400).
CARD_SHAPES = [(24, 32, 192), (1, 32, 192), (7, 32, 192), (2, 16, 96),
               (2, 48, 200), (3, 8, 64), (1, 8, 400)]


def test_lpsr_pack_splits_lff_exactly_and_flags_bf16_exactness():
    """The folded lff weight as a bf16 pair hi + lo, bit for bit, for the
    real checkpoint in bf16; bf16_exact holds there, and not for the same
    checkpoint in float32."""
    packed = kl.lpsr_pack(tlpsr.load_lpsr(LPSR, device="cpu")
                          .to(torch.bfloat16))
    for r in range(2):
        hi, lo = packed.lff_hi[r], packed.lff_lo[r]
        assert hi.dtype == lo.dtype == torch.bfloat16
        assert hi.shape == lo.shape == (96, 32)
        w = packed[f"rdb{r}.lff.w"]
        assert torch.equal((hi.float() + lo.float()).view(torch.int32),
                           w.view(torch.int32))
        assert (lo != 0).any()          # the product needs both halves
    assert packed.bf16_exact
    assert packed.mma.dtype == torch.bfloat16
    assert len(packed.mma_offsets) == len(kl.MMA_KEYS) == 18
    assert all(o % 8 == 0 for o in packed.mma_offsets)
    assert not kl.lpsr_pack(tlpsr.load_lpsr(LPSR, device="cpu")).bf16_exact


def test_lpsr_pack_b_tiles_hold_the_weights():
    """The bf16 B tiles, unswizzled, give back each wide stage's weights:
    per 16-channel chunk, per part, per tap, per output channel, its 16
    input channels with the 16-byte halves swapped where bit 2 of the
    output channel is set."""
    packed = kl.lpsr_pack(tlpsr.load_lpsr(LPSR, device="cpu")
                          .to(torch.bfloat16))
    ends = list(packed.mma_offsets[1:]) + [packed.mma.numel()]
    for key, start, end in zip(kl.MMA_KEYS, packed.mma_offsets, ends):
        if key.endswith(".lff"):
            r = int(key[3])
            parts = [packed.lff_hi[r].float(), packed.lff_lo[r].float()]
        else:
            parts = [packed[f"{key}.w"]]
        w = torch.stack([v.reshape(-1, *v.shape[-2:]) for v in parts])
        n_parts, taps, cin, cout = w.shape
        t = packed.mma[start:end].float().view(cin // 16, n_parts, taps,
                                               cout, 2, 8)
        swap = ((torch.arange(cout) >> 2) & 1).bool()
        t = torch.where(swap[:, None, None], t.flip(4), t)
        got = t.permute(1, 2, 0, 4, 5, 3).reshape(n_parts, taps, cin, cout)
        assert torch.equal(got, w), key


def _tf32_bits_low(t):
    """The 13 low mantissa bits of float32 t, as int32."""
    return t.contiguous().view(torch.int32) & 0x1FFF


def test_tf32_round_rounds_to_nearest_ties_away():
    """tf32_round keeps 10 mantissa bits, rounds to nearest with ties away
    from zero (cvt.rna.tf32.f32) and zeroes the 13 low bits; against a
    numpy rounding of the same bits in float64 on random values."""
    one = 1.0
    x = torch.tensor([one + 2 ** -11, -(one + 2 ** -11), one + 3 * 2 ** -11,
                      one + 2 ** -11 - 2 ** -23, 3.0, 0.0, -0.0],
                     dtype=torch.float32)
    got = kl.tf32_round(x)
    want = [one + 2 ** -10, -(one + 2 ** -10), one + 2 ** -9, one, 3.0, 0.0,
            -0.0]
    assert got.tolist() == want
    rng = np.random.RandomState(0)
    v = (rng.randn(10000) * 10.0 ** rng.randint(-6, 6, 10000)
         ).astype(np.float32)
    r = kl.tf32_round(torch.from_numpy(v)).numpy().astype(np.float64)
    assert not _tf32_bits_low(torch.from_numpy(r.astype(np.float32))).any()
    # the nearest TF32 value: |v - r| <= half a TF32 ulp of |v|'s binade
    ulp = 2.0 ** (np.floor(np.log2(np.abs(v.astype(np.float64)))) - 10)
    assert (np.abs(v - r) <= ulp / 2).all()


def test_lpsr_pack_tf32_split_reproduces_the_wide_weights():
    """A float32 pack's TF32 tiles: each wide weight (the folded lff too)
    as big = tf32(w) and small = tf32(w - big), both with their 13 low
    mantissa bits zero, big + small within 2^-21 of w relative; only a
    float32 model's pack has them, and a float32 launch needs them."""
    packed = kl.lpsr_pack(tlpsr.load_lpsr(LPSR, device="cpu"))
    assert packed.tf32.dtype == torch.float32
    assert len(packed.tf32_offsets) == len(kl.MMA_KEYS) == 18
    assert all(o % 8 == 0 for o in packed.tf32_offsets)
    assert packed.tiles(torch.float32)[0] is packed.tf32
    for key in kl.MMA_KEYS:
        w = packed[f"{key}.w"]
        big = kl.tf32_round(w)
        small = kl.tf32_round(w - big)
        assert not _tf32_bits_low(big).any() and not _tf32_bits_low(small).any()
        rel = ((big.double() + small.double() - w.double()).abs()
               / w.double().abs().clamp_min(1e-30))
        assert rel.max() <= 2.0 ** -21, key
        assert (small != 0).any(), key          # the weights need both parts
    bf = kl.lpsr_pack(tlpsr.load_lpsr(LPSR, device="cpu").to(torch.bfloat16))
    assert bf.tf32 is None and bf.tiles(torch.bfloat16)[0] is bf.mma
    with pytest.raises(ValueError):
        bf.tiles(torch.float32)


def test_lpsr_pack_tf32_tiles_hold_the_weights():
    """The TF32 tiles, unswizzled, give back each wide stage's big and
    small weights: per 8-channel chunk, per part (big, small), per tap, per
    output channel, its 8 input channels with the 16-byte halves swapped
    where bit 2 of the output channel is set."""
    packed = kl.lpsr_pack(tlpsr.load_lpsr(LPSR, device="cpu"))
    ends = list(packed.tf32_offsets[1:]) + [packed.tf32.numel()]
    for key, start, end in zip(kl.MMA_KEYS, packed.tf32_offsets, ends):
        v = packed[f"{key}.w"]
        big = kl.tf32_round(v)
        w = torch.stack([p.reshape(-1, *p.shape[-2:])
                         for p in (big, kl.tf32_round(v - big))])
        n_parts, taps, cin, cout = w.shape
        t = packed.tf32[start:end].view(cin // 8, n_parts, taps, cout, 2, 4)
        swap = ((torch.arange(cout) >> 2) & 1).bool()
        t = torch.where(swap[:, None, None], t.flip(4), t)
        got = t.permute(1, 2, 0, 4, 5, 3).reshape(n_parts, taps, cin, cout)
        assert torch.equal(got, w), key


def test_tf32x3_lpsr_matches_lpsr_apply(jax_params, monkeypatch):
    """The float32 kernel's arithmetic on the CPU: lpsr_plain with each of
    the 23 wide stages computed as the three split products (conv2d of
    a_small * b_big + a_big * b_small + a_big * b_big in float32, a_* the
    TF32 split of the stored input, b_* of the weight), real weights, two
    crops, against lpsr_apply (JAX at 'highest') within the float32 TOL_*
    (1e-4 max, 1e-5 mean): the design keeps the bound."""
    params = jax_params["real"]
    _, packed = _port(params)
    wide = {packed[f"{k}.w"].data_ptr() for k in kl.MMA_KEYS}
    assert len(wide) == 23 - 5              # the CSAR's 5 run twice
    plain_conv, calls = kl._conv, []

    def split_conv(z, w, b=None, groups=1):
        if w.data_ptr() not in wide:
            return plain_conv(z, w, b, groups)
        calls.append(w.data_ptr())
        z = z.float()
        a_big = kl.tf32_round(z)
        a_small = kl.tf32_round(z - a_big)
        w_big = kl.tf32_round(w)
        w_small = kl.tf32_round(w - w_big)
        return (plain_conv(a_small, w_big) + plain_conv(a_big, w_small)
                + plain_conv(a_big, w_big, b))

    monkeypatch.setattr(kl, "_conv", split_conv)
    x = _crops(2, 2)
    got = kl.lpsr_plain(torch.from_numpy(x), packed).numpy()
    assert len(calls) == 23
    ref = np.asarray(jax.jit(lambda p, v: lpsr_apply(p, v, CFG))(
        params, jnp.asarray(x)))
    err = np.abs(got - ref)
    assert err.max() < kl.TOL_MAX[torch.float32], err.max()
    assert err.mean() < kl.TOL_MEAN[torch.float32], err.mean()


def test_lpsr_stage_work_sums_to_lpsr_work():
    """35 stages in the stage tool's order; twice their multiply-adds are
    lpsr_work's operations; the 23 tensor-core stages hold >= 94 % of the
    work."""
    for shape in [(24, 32, 192), (1, 8, 64), (2, 48, 200)]:
        work = kl.lpsr_stage_work(*shape)
        assert tuple(work) == kl.STAGES and len(kl.STAGES) == 35
        assert 2 * sum(work.values()) == kl.lpsr_work(*shape)[0]
        mma = sum(v for k, v in work.items() if k in kl.MMA_STAGES)
        assert len(kl.MMA_STAGES) == 23 and kl.MMA_STAGES <= set(kl.STAGES)
        assert mma >= 0.94 * sum(work.values())


def test_stage_tool_finds_its_anchors_in_the_kernel_source():
    """tools/lpsr_stages.py stamps K2's source at the kernel's start,
    after every stage barrier and at its end: the committed source must
    hold each anchor once."""
    from pathlib import Path

    from lpr_tpu_torch.kernels._build import CSRC
    from lpr_tpu_torch.tools import lpsr_stages

    text = (Path(CSRC) / "lpsr.cu").read_text()
    stamped = lpsr_stages.stamped_source(text)
    assert stamped.count("stamp();") == 3
    assert "lpr_lpsr_read_stamps" in stamped
    assert lpsr_stages.STAGES == kl.STAGES
    lines = lpsr_stages.report([1.0] * 35, 24, 32, 192)
    assert len(lines) == 35
    assert sum(line.endswith(" mma") for line in lines) == 23
    lines = lpsr_stages.report([1.0] * 35, 64, 32, 192, "float32")
    assert len(lines) == 35
    assert sum(line.endswith(" tf32x3") for line in lines) == 23
    assert sum(line.endswith(" scalar") for line in lines) == 12
    with pytest.raises(ValueError):
        lpsr_stages.stamped_source(text.replace("stage_barrier() {", "x"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_matches_plain_version_on_card(dtype, shape):
    """K2 vs lpsr_plain on the card at the main path's (24, 32, 192, 3)
    and the other CARD_SHAPES, real weights, within kl.TOL_MAX / TOL_MEAN
    of the activation dtype; a bf16 launch with a pack that is not exact
    in bf16 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    model = tlpsr.load_lpsr(LPSR, device="cuda").to(dt)
    p = kl.lpsr_pack(model)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((*shape, 3), generator=g, device="cuda").to(dt)
    if dt == torch.float32:
        with pytest.raises(ValueError):
            kl.lpsr_fused(x.to(torch.bfloat16), p)
    before = kl.lpsr_fused.launches
    got = kl.lpsr_fused(x, p)
    ref = kl.lpsr_plain(x, p)
    torch.cuda.synchronize()
    assert kl.lpsr_fused.launches == before + 1
    max_err, mean_err = kl.lpsr_errors(got, ref)
    assert max_err < kl.TOL_MAX[dt], max_err
    assert mean_err < kl.TOL_MEAN[dt], mean_err


def test_sass_counts_reads_a_cuobjdump_listing(monkeypatch):
    """_build.sass_counts, which chip_smoke.py uses to show HMMA in
    lpsr_kernel<bf16>: opcodes counted per function, predicated ones too,
    and the encoding lines skipped."""
    import subprocess
    import types

    from lpr_tpu_torch.kernels import _build

    listing = """
        code for sm_90a
                Function : _ZN2_111lpsr_kernelI13__nv_bfloat16EEvPKT_
        .headerflags    @"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;  /* 0x0 */
        /*0020*/               @P0 HMMA.16816.F32.BF16 R4, R8, R14, R4 ;  /* 0x0 */
                Function : _ZN2_111lpsr_kernelIfEEvPKT_
        /*0000*/                   FFMA R1, R2, R3, R1 ;    /* 0x0 */
"""
    monkeypatch.setattr(_build, "nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=listing))
    assert _build.sass_counts("lib.so", "HMMA") == {
        "_ZN2_111lpsr_kernelI13__nv_bfloat16EEvPKT_": 2,
        "_ZN2_111lpsr_kernelIfEEvPKT_": 0}
