"""I2's fused epilogue and I1's slots, without the JAX package: the plain
fused chain against the composition the model used to run (conv_int8_plain,
the activation, + the shortcut, the max of the result), on the CPU; and,
on a card, every I2 instance (bf16 and float32 output x act none, SiLU,
leaky x residual or not x max or not; the raw sums; N tiles of 64 and 128)
and I1's max pass and quantize with 1-4 slots, bit for bit against their
plain versions."""

import numpy as np
import pytest
import torch

from lpr_tpu_torch.kernels import conv_int8 as ki
from lpr_tpu_torch.ops import nn as tnn

# (batch, H, W, Cin, Cout, k, stride): a 3x3 same conv with Cout = Cin,
# as a shortcut's cv2; a 1x1 with Cin 96 (32-channel k-stages) and Cout
# ragged against the tiles; a 3x3 stride 2 with 256 channels (128-channel
# stages).
CASES = [(2, 13, 17, 64, 64, 3, 1), (2, 9, 11, 96, 70, 1, 1),
         (1, 12, 10, 256, 136, 3, 2)]
DTYPES = ["bfloat16", "float32"]


def _operands(case, dtype, device, tiny=False):
    """Codes, sx, the int8 weight, scales and bias, and a residual of the
    output's shape, made with numpy from a fixed seed; ``tiny`` scales the
    weight's scales by 1e-29 so that outputs straddle SiLU's 1e-30 flush."""
    B, H, W, cin, cout, k, s = case
    rng = np.random.RandomState(cin + cout + k)
    x = torch.from_numpy(rng.randn(B, H, W, cin).astype(np.float32)).to(
        device, getattr(torch, dtype))
    wq, ws = tnn.quantize_conv_weight(
        (rng.randn(k, k, cin, cout) * 0.05).astype(np.float32))
    if tiny:
        ws = ws * np.float32(1e-29)
    b = (rng.randn(cout) * (1e-30 if tiny else 0.5)).astype(np.float32)
    ho, wo = (H + 2 * (k // 2) - k) // s + 1, (W + 2 * (k // 2) - k) // s + 1
    res = torch.from_numpy(rng.randn(B, ho, wo, cout).astype(np.float32)).to(
        device, getattr(torch, dtype))
    xq, sx = ki.quantize_act_plain(x)
    return (x, xq, sx, torch.from_numpy(wq).to(device),
            torch.from_numpy(ws).to(device), torch.from_numpy(b).to(device),
            res)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_plain_epilogue_is_the_composed_chain(case, dtype):
    """conv_int8 on the CPU with act (none, SiLU, leaky), residual and
    amax equals conv_int8_plain rounded to the dtype, then ops.nn.silu or
    leaky_relu(0.1) (ConvAct's activations), then residual + y
    (Bottleneck's shortcut), and its slot the max|y| of that, bit for
    bit."""
    x, xq, sx, wq, ws, b, res = _operands(case, dtype, "cpu")
    dt = getattr(torch, dtype)
    k, s = case[5], case[6]
    kw = dict(stride=(s, s), padding=(k // 2, k // 2))
    base = ki.conv_int8_plain(xq, sx, wq, ws, b, out_dtype=dt, **kw)
    acts = {"none": base, "silu": tnn.silu(base),
            "leaky": tnn.leaky_relu(base, 0.1)}
    for act, ref in acts.items():
        for r in (None, res):
            slot = torch.zeros(1)
            got = ki.conv_int8(xq, sx, wq, ws, b, out_dtype=dt, act=act,
                               residual=r, amax=slot, **kw)
            want = ref if r is None else r + ref
            assert got.dtype == dt and torch.equal(got, want), (act, r is None)
            assert torch.equal(slot, want.float().abs().amax().reshape(1))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_quantize_reads_the_max_of_its_slots(n):
    """quantize_act with n slots (the max passes of n channel slices, as a
    concat's parts carry them) equals quantize_act_plain on the whole
    tensor on the CPU; the slots take each slice's max|x|."""
    x = torch.from_numpy(np.random.RandomState(n).randn(2, 5, 7, 72)
                         .astype(np.float32)) * torch.linspace(0.5, 3, 72)
    parts = torch.tensor_split(x, n, dim=-1)
    slots = [torch.zeros(1) for _ in parts]
    for p, s in zip(parts, slots):
        ki.act_amax(p.contiguous(), s)
        assert torch.equal(s, ki.act_amax_plain(p).reshape(1))
    xq, sx = ki.quantize_act(x, slots)
    pxq, psx = ki.quantize_act_plain(x)
    assert torch.equal(xq, pxq) and torch.equal(sx, psx)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + [(2, 92, 96, 64, 128, 3, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_i2_instances_match_plain_versions_on_card(case, dtype):
    """Every instance of I2 on the card (the raw sums; act none, SiLU,
    leaky x residual or not x max or not) equal to the plain versions on
    the card bit for bit: the sums, the output and the slot's max|y|.  The
    last case has M = 17,664 and Cout 128, so it takes the 128-wide N
    tile; the others 64."""
    _card()
    x, xq, sx, wq, ws, b, res = _operands(case, dtype, "cuda")
    dt = getattr(torch, dtype)
    k, s = case[5], case[6]
    kw = dict(stride=(s, s), padding=(k // 2, k // 2))
    pk = ki.int8_pack(wq)
    n0 = ki.conv_int8.launches
    acc = ki.conv_int8(xq, sx, wq, ws, b, packed=pk, raw=True, **kw)
    assert torch.equal(acc, ki.conv_int8_plain(xq, sx, wq, ws, b, raw=True,
                                               **kw))
    launches = 1
    for act in ki.ACTS:
        for r in (None, res):
            ref = ki.conv_int8_plain(xq, sx, wq, ws, b, out_dtype=dt,
                                     act=act, residual=r, **kw)
            for with_max in (False, True):
                slot = torch.zeros(1, device="cuda") if with_max else None
                got = ki.conv_int8(xq, sx, wq, ws, b, packed=pk,
                                   out_dtype=dt, act=act, residual=r,
                                   amax=slot, **kw)
                launches += 1
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (act, r is None, with_max,
                                               (got.float() - ref.float())
                                               .abs().max().item())
                if with_max:
                    assert torch.equal(slot, ref.float().abs().amax()
                                       .reshape(1))
    assert ki.conv_int8.launches == n0 + launches
    with pytest.raises(ValueError, match="groups"):
        ki.conv_int8(xq, sx, wq, ws, b, packed=pk, groups=2, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_i2_silu_flush_matches_plain_version_on_card(dtype):
    """Outputs around SiLU's |y| < 1e-30 flush (the weight's scales times
    1e-29): the kernel flushes exactly where ops.nn.silu does on the card,
    in bf16 (against bf16(1e-30)) and float32."""
    _card()
    case = CASES[0]
    x, xq, sx, wq, ws, b, res = _operands(case, dtype, "cuda", tiny=True)
    dt = getattr(torch, dtype)
    kw = dict(stride=(1, 1), padding=(1, 1))
    ref = ki.conv_int8_plain(xq, sx, wq, ws, b, out_dtype=dt, act="silu",
                             **kw)
    got = ki.conv_int8(xq, sx, wq, ws, b, packed=ki.int8_pack(wq),
                       out_dtype=dt, act="silu", **kw)
    assert 0.05 < (ref == 0).float().mean() < 0.95
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_i2_bf16_silu_sweep_matches_plain_version_on_card():
    """The bf16 SiLU epilogue (the accurate sigmoid, ``1 / (1 + expf(-v))``
    as PyTorch's CUDA sigmoid computes it) over a sweep of inputs:
    one code q in -127..127 a position and a 1x1 weight of ones, so that
    output channel n holds q * 2^-(n % 24) * 1.7 + bias_n, biases from -24
    to 24: 65,280 values from ~1e-7 to ~300 in magnitude, equal to the
    plain version's on the card bit for bit."""
    _card()
    q = torch.arange(-127, 128, dtype=torch.int8)
    xq = torch.zeros((1, 1, 255, 32), dtype=torch.int8)
    xq[0, 0, :, 0] = q
    n = torch.arange(256)
    ws = (1.7 * torch.pow(2.0, -(n % 24).float())).float()
    b = torch.linspace(-24, 24, 256)
    wq = torch.zeros((1, 1, 32, 256), dtype=torch.int8)
    wq[0, 0, 0, :] = 1
    xq, wq, ws, b = xq.cuda(), wq.cuda(), ws.cuda(), b.cuda()
    sx = torch.ones(1, device="cuda")
    kw = dict(stride=(1, 1), padding=(0, 0))
    ref = ki.conv_int8_plain(xq, sx, wq, ws, b, out_dtype=torch.bfloat16,
                             act="silu", **kw)
    got = ki.conv_int8(xq, sx, wq, ws, b, packed=ki.int8_pack(wq),
                       out_dtype=torch.bfloat16, act="silu", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), int((got != ref).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_i1_slots_match_plain_versions_on_card(n, dtype):
    """I1 on the card: the max pass into n slots (channel slices) and the
    quantize that reads them equal the plain versions bit for bit (codes,
    sx, each slot); quantize_act without slots runs the max pass itself."""
    _card()
    dt = getattr(torch, dtype)
    x = (torch.from_numpy(np.random.RandomState(n).randn(4, 23, 40, 96)
                          .astype(np.float32))
         * torch.linspace(0.5, 3, 96)).to("cuda", dt)
    parts = [p.contiguous() for p in torch.tensor_split(x, n, dim=-1)]
    slots = torch.zeros(n, device="cuda")
    a0, q0 = ki.act_amax.launches, ki.quantize_act.launches
    for i, p in enumerate(parts):
        ki.act_amax(p, slots[i:i + 1])
    xq, sx = ki.quantize_act(x, [slots[i:i + 1] for i in range(n)])
    xq1, sx1 = ki.quantize_act(x)
    torch.cuda.synchronize()
    assert (ki.act_amax.launches, ki.quantize_act.launches) == (a0 + n + 1,
                                                               q0 + 2)
    for i, p in enumerate(parts):
        assert torch.equal(slots[i], ki.act_amax_plain(p))
    pxq, psx = ki.quantize_act_plain(x)
    for got_q, got_s in ((xq, sx), (xq1, sx1)):
        assert torch.equal(got_q, pxq) and torch.equal(got_s, psx)
