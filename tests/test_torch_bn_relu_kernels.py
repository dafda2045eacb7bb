"""The ConvBlock's inference epilogue (``ops/cuda/bn_relu_kernel.py``).

On the CPU the wrapper runs its plain version, which has to be the unfused
``BatchNorm`` (running statistics) -> relu (-> ``avg_pool2d``) of
``models/encoders.py`` bit for bit, and ``ConvBlock`` takes it only at
inference.  The tests marked ``cuda`` hold the kernel against its plain
version on a card, bit for bit; without one they skip.  This file imports
no JAX, so on a machine with a card it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_bn_relu_kernels.py
"""
import copy

import pytest
import torch
import torch.nn.functional as F

from acvae_tpu_torch.models.encoders import BatchNorm, Cnn10, Cnn14, ConvBlock
from acvae_tpu_torch.ops.cuda import bn_relu_kernel
from acvae_tpu_torch.ops.cuda import build as tbuild
from acvae_tpu_torch.ops.cuda.bn_relu_kernel import bn_relu, bn_relu_op, bn_relu_ref

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
INT_VIEW = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def same_bits(a, b):
    """Equal shapes, dtypes and bits (NaNs and signed zeros included)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(INT_VIEW[a.dtype]), b.view(INT_VIEW[b.dtype])))


def bn_case(c, seed, device="cpu", params=torch.float32):
    """A BatchNorm of ``c`` channels with drawn running statistics, scale
    and bias (a few scales negative); the scale and bias in ``params``, as
    the bf16 decode casts them (``ops/amp.py::cast_floats_for_decode``)."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.05)
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g) * 0.3)
    for p in bn.parameters():
        p.data = p.data.to(params)
    return bn.to(device)


def conv_out(n, c, h, w, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, c, h, w), generator=g) * 2).to(dtype).to(device)


def unfused(bn, x, pool):
    """Today's ConvBlock epilogue at inference, op by op."""
    y = F.relu(bn(x, False, dtype=x.dtype))
    return F.avg_pool2d(y, 2) if pool else y


def fused(bn, x, pool):
    return bn_relu(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                   bn.eps, pool)


# (N, C, H, W): Cnn14's block shapes cut to a small batch and height, and
# odd T and F
SHAPES = [(2, 4, 16, 64), (2, 6, 8, 32), (2, 8, 8, 16), (2, 8, 6, 8),
          (2, 8, 6, 4), (2, 8, 4, 2), (3, 5, 7, 9), (1, 3, 5, 1), (2, 2, 1, 6)]


# --------------------------------------------------------------------- #
# the plain version and the wrapper, on the CPU
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("params", list(DTYPES), ids=lambda p: f"{p}_params")
@pytest.mark.parametrize("pool", [False, True], ids=["plain", "pooled"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_is_the_unfused_ops(shape, dtype, pool, params):
    bn = bn_case(shape[1], seed=sum(shape), params=DTYPES[params])
    x = conv_out(*shape, DTYPES[dtype], seed=7)
    before = bn_relu.launches
    if pool and min(shape[2:]) < 2:   # avg_pool2d refuses an empty output
        with pytest.raises(RuntimeError), torch.inference_mode():
            unfused(bn, x, pool)
        with pytest.raises(ValueError, match="empty"):
            fused(bn, x, pool)
        return
    with torch.inference_mode():
        got = fused(bn, x, pool)
        want = unfused(bn, x, pool)
    assert same_bits(got, want)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    assert same_bits(bn_relu_ref(x, bn.running_mean, mul, bn.bias, pool), want)
    assert bn_relu.launches == before
    assert "bn_relu" not in tbuild._LIBS


def test_plain_version_keeps_nan_inf_and_signed_zeros():
    """NaN inputs, overflow to inf in bf16 and x == mean with a bias of -0
    (a -0 before the relu) give the unfused ops' bits."""
    bn = bn_case(4, seed=3)
    with torch.no_grad():
        bn.bias[0] = -0.0
        bn.running_mean[0] = 0.25
        bn.weight[1] = 3e38
    x = conv_out(2, 4, 6, 8, torch.bfloat16, seed=4)
    x[0, 0, :2] = 0.25
    x[1, 2, 0, :3] = float("nan")
    x[0, 3, 1, 0] = float("inf")
    for pool in (False, True):
        with torch.inference_mode():
            assert same_bits(fused(bn, x, pool), unfused(bn, x, pool))


def test_wrapper_checks_inputs():
    bn = bn_case(4, seed=5)
    stats = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    x = conv_out(2, 4, 6, 8, torch.bfloat16, seed=6)
    with pytest.raises(TypeError):
        bn_relu(x.half(), *stats)
    with pytest.raises(TypeError):
        bn_relu(x, bn.running_mean.double(), *stats[1:])
    with pytest.raises(ValueError, match="empty"):
        bn_relu(x[:, :, :1], *stats, pool=True)
    with pytest.raises(ValueError):
        bn_relu(x[:, :3], *stats)
    with pytest.raises(ValueError):
        bn_relu(x[0], *stats)
    meta = [t.to("meta") for t in (x,) + stats[:4]]
    with pytest.raises(ValueError, match="unsupported device"):
        bn_relu(*meta, bn.eps)                       # no silent path


@pytest.mark.parametrize("pool", [False, True], ids=["plain", "pooled"])
def test_operator_opcheck(pool):
    bn = bn_case(4, seed=8)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    for shape in ((2, 4, 6, 8), (1, 4, 5, 3)):
        x = conv_out(*shape, torch.bfloat16, seed=9)
        torch.library.opcheck(bn_relu_op, (x, bn.running_mean.detach(), mul.detach(),
                                           bn.bias.detach(), pool))


# --------------------------------------------------------------------- #
# ConvBlock's dispatch
# --------------------------------------------------------------------- #
def block_case(dtype, seed=0):
    torch.manual_seed(seed)
    blk = ConvBlock(3, 8, dtype)
    for i, bn in enumerate((blk.bn1, blk.bn2)):
        drawn = bn_case(8, seed=seed + i)
        bn.load_state_dict(drawn.state_dict())
    x = torch.randn(2, 3, 12, 10)
    return blk, x


def unfused_block(blk, x, train, pool_size=(2, 2), pool_type="avg"):
    """Today's ConvBlock.forward, written out."""
    from acvae_tpu_torch.models.encoders import _conv2d, _pool2d
    for conv, bn in ((blk.conv1, blk.bn1), (blk.conv2, blk.bn2)):
        x = F.relu(bn(_conv2d(x, conv, blk.dtype), train, dtype=blk.dtype))
    return _pool2d(x, pool_size, pool_type)


@pytest.fixture
def spy(monkeypatch):
    """The calls ConvBlock makes of ``bn_relu`` (its ``pool`` flags)."""
    calls, real = [], bn_relu_kernel.bn_relu

    def wrapped(*args):
        calls.append(args[-1])
        return real(*args)
    monkeypatch.setattr(bn_relu_kernel, "bn_relu", wrapped)
    return calls


@pytest.mark.parametrize("pool_size,pool_type,flags", [
    ((2, 2), "avg", [False, True]), ((1, 1), "avg", [False, False]),
    ((2, 2), "max", [False, False]), ((2, 2), "avg+max", [False, False])])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_convblock_inference_takes_the_one_pass(spy, dtype, pool_size, pool_type,
                                                flags):
    blk, x = block_case(DTYPES[dtype])
    with torch.inference_mode():
        got = blk(x, False, pool_size=pool_size, pool_type=pool_type)
        want = unfused_block(blk, x, False, pool_size, pool_type)
    assert spy == flags
    assert same_bits(got, want)
    with torch.no_grad():
        assert same_bits(blk(x, False, pool_size=pool_size, pool_type=pool_type),
                         want)
    assert spy == flags * 2


@pytest.mark.parametrize("train", [True, False], ids=["train", "autograd"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_convblock_train_or_autograd_keeps_the_unfused_path(spy, dtype, train):
    """Train-mode statistics, or ``train=False`` under autograd (as
    PreTrainedCNN's trunk runs): the unfused ops, the same outputs,
    running statistics and gradients as before."""
    blk, x = block_case(DTYPES[dtype], seed=1)
    ref = copy.deepcopy(blk)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = bn_relu.launches
    got = blk(xa, train)
    want = unfused_block(ref, xb, train)
    assert spy == [] and bn_relu.launches == before
    assert same_bits(got, want)
    got.float().square().sum().backward()
    want.float().square().sum().backward()
    assert torch.equal(xa.grad, xb.grad)
    for (name, p), q in zip(blk.named_parameters(), ref.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for (name, b), c in zip(blk.named_buffers(), ref.buffers()):
        assert torch.equal(b, c), name


def test_pann_encoders_at_inference_equal_the_unfused_path(spy, monkeypatch):
    """Cnn10 and Cnn14 (tiny Cnn10, Cnn14 at its own widths on a short
    clip) under inference_mode: one call a conv, pooled after each pooled
    block's second conv, and the bits of the unfused path."""
    torch.manual_seed(2)
    feats = torch.randn(1, 64, 64)
    lens = torch.tensor([64])
    for enc, flags in ((Cnn10(channels=(4, 8, 8, 16), embed_size=16,
                              dtype=torch.bfloat16), [False, True] * 4),
                       (Cnn14(dtype=torch.bfloat16),
                        [False, True] * 5 + [False, False])):
        enc.eval()
        spy.clear()
        with torch.inference_mode():
            got = enc(feats, lens)
        assert spy == flags
        with monkeypatch.context() as m, torch.inference_mode():
            m.setattr(ConvBlock, "forward", unfused_block)
            want = enc(feats, lens)
        for k in got:
            assert torch.equal(got[k], want[k]), k


# --------------------------------------------------------------------- #
# the kernel, on a card
# --------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the kernel has no CPU "
                    "mode; chip_smoke.py checks it on the card)")


# Cnn14's six blocks at T_mel 1024, F 64, batch 2: (C, H, W) of each conv's
# output; conv2 pools in blocks 1-5
CNN14_BLOCKS = [(64, 1024, 64), (128, 512, 32), (256, 256, 16), (512, 128, 8),
                (1024, 64, 4), (2048, 32, 2)]
# odd T and F, planes that are not whole 16-byte vectors, W of 1 to 3, rows
# of 1, 2, 4 and 16 pooled values at odd heights
ODD_SHAPES = [(2, 3, 7, 9), (3, 5, 33, 65), (2, 4, 9, 2), (2, 4, 10, 4),
              (2, 4, 11, 8), (1, 6, 5, 1), (2, 2, 1, 6), (2, 8, 6, 3),
              (2, 16, 4, 12), (1, 3, 64, 6), (2, 4, 16, 2), (2, 4, 17, 4),
              (2, 3, 33, 32)]


def card_case(shape, dtype, seed, params=torch.float32):
    bn = bn_case(shape[1], seed=seed, device="cuda", params=params)
    return bn, conv_out(*shape, dtype, seed=seed + 1, device="cuda")


def plain_on_card(bn, x, pool):
    """The plain version, fed as the wrapper feeds the kernel."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return bn_relu_ref(x, bn.running_mean.float(), mul.float(), bn.bias.float(),
                       pool)


@pytest.mark.cuda
@pytest.mark.parametrize("params", list(DTYPES), ids=lambda p: f"{p}_params")
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("block", range(6), ids=lambda b: f"block{b + 1}")
def test_kernel_matches_plain_at_cnn14_shapes(card, block, dtype, params):
    C, H, W = CNN14_BLOCKS[block]
    bn, x = card_case((2, C, H, W), DTYPES[dtype], seed=block, params=DTYPES[params])
    for pool in (False, True) if block < 5 else (False,):
        before = bn_relu.launches
        with torch.inference_mode():
            got = fused(bn, x, pool)
        assert bn_relu.launches == before + 1
        want = plain_on_card(bn, x, pool)
        assert torch.equal(got, want) and same_bits(got, want), (block, pool)
        with torch.inference_mode():
            assert same_bits(unfused(bn, x, pool), want), (block, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_at_odd_shapes(card, shape, dtype):
    bn, x = card_case(shape, DTYPES[dtype], seed=sum(shape))
    for pool in (False, True) if min(shape[2:]) >= 2 else (False,):
        got = fused(bn, x, pool)
        assert same_bits(got, plain_on_card(bn, x, pool)), pool


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_kernel_keeps_nan_inf_signed_zeros_and_unaligned_inputs(card, dtype):
    dt = DTYPES[dtype]
    bn, x = card_case((2, 4, 6, 16), dt, seed=11)
    with torch.no_grad():
        bn.bias[0] = -0.0
        bn.running_mean[0] = 0.25
        bn.weight[1] = 3e38
    x[0, 0, :2] = 0.25
    x[1, 2, 0, :3] = float("nan")
    x[0, 3, 1, 0] = float("-inf")
    buf = torch.empty(x.numel() + 1, dtype=dt, device="cuda")
    shifted = buf[1:].view(x.shape)                  # contiguous, not 16-byte aligned
    shifted.copy_(x)
    for pool in (False, True):
        want = plain_on_card(bn, x, pool)
        assert same_bits(fused(bn, x, pool), want), pool
        assert same_bits(fused(bn, shifted, pool), want), pool


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    bn, x = card_case((2, 4, 6, 8), torch.bfloat16, seed=12)
    stats = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    with pytest.raises(ValueError, match="contiguous"):
        bn_relu(x.transpose(2, 3), *stats)
    with pytest.raises(ValueError, match="contiguous"):
        bn_relu(x.to(memory_format=torch.channels_last), *stats)
    with pytest.raises(TypeError):
        bn_relu(x.half(), *stats)
    with pytest.raises(ValueError, match="devices"):
        bn_relu(x, bn.running_mean.cpu(), *stats[1:])


@pytest.mark.cuda
def test_pann_serving_batch_launches(card):
    """One bf16 batch under inference_mode: 12 launches for Cnn14, 8 for
    Cnn10; none in a train-mode forward."""
    feats = torch.randn(2, 256, 64, device="cuda")
    lens = torch.tensor([256, 200], device="cuda")
    for enc, n in ((Cnn14(dtype=torch.bfloat16, device="cuda"), 12),
                   (Cnn10(dtype=torch.bfloat16, device="cuda"), 8)):
        before = bn_relu.launches
        with torch.inference_mode():
            enc.eval()(feats, lens)
        assert bn_relu.launches == before + n
        enc.train()(feats, lens, train=True)
        assert bn_relu.launches == before + n
