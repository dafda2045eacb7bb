"""The beam's top-k (``ops/cuda/topk_kernel.py``).

On the CPU the operator runs its plain version, the stable descending sort
cut to ``k``, which has to be ``lax.top_k``'s order; ``topk_lax_order``
takes the operator on every device and for every ``k``.  The tests marked
``cuda`` hold the kernel against the card's stable sort, bit for bit, a
``k`` above ``ROUND_K`` over several launches; without a card they skip.  The card's tests
import no JAX, so on a machine with a card they run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_topk_kernel.py
"""
import copy

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from acvae_tpu_torch.decoding import beam
from acvae_tpu_torch.decoding.beam import BeamConfig, batched_beam_search
from acvae_tpu_torch.ops.cuda import build as tbuild
from acvae_tpu_torch.ops.cuda import topk_kernel
from acvae_tpu_torch.ops.cuda.topk_kernel import topk_rows, topk_rows_op, topk_rows_ref


def same_bits(a, b):
    """Equal shapes, dtypes and bits (NaNs and signed zeros included)."""
    view = {torch.float32: torch.int32, torch.int64: torch.int64}[a.dtype]
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(view), b.view(view)))


def sort_cut(x, k):
    """Today's top-k: the stable descending sort, cut to ``k``."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def rows_case(name, seed=0):
    """(rows [R, M] float32, the k to take) of one named case."""
    g = np.random.default_rng(seed)
    inf = np.inf
    if name == "ties_across_kth":      # a tie straddles the k-th place
        x = [[1, 3, 3, 2, 3, 0, 3], [5, 4, 4, 4, 1, 4, 0], [0, 2, 2, 2, 1, 2, 2]]
        return np.array(x, np.float32), 2
    if name == "all_equal":
        return np.full((3, 13), -2.5, np.float32), 5
    if name == "inf":
        x = [[-inf, 1, inf, -inf, inf, 0, 2], [-inf] * 7, [inf, -inf, -1, inf, 3, 3, -inf]]
        return np.array(x, np.float32), 3
    if name == "signed_zeros":   # +0.0 and -0.0 tie across the k-th place
        x = [[-0.0, 0.0, -1, -0.0, 0.0, -2, -3], [0.0, -0.0, 0.0, -0.0, -0.0, 0.0, -0.0],
             [-5, -0.0, 1, 0.0, -0.0, 2, -1]]
        return np.array(x, np.float32), 4
    if name.startswith("coarse_m"):   # many exact ties at an odd width
        m = int(name[len("coarse_m"):])
        # + 0.0: no -0.0, whose tie order lax.top_k takes apart (below)
        return (np.round(g.normal(size=(5, m)) * 2) / 2 + 0.0).astype(np.float32), min(3, m)
    if name.startswith("drawn_m"):
        m = int(name[len("drawn_m"):])
        return g.normal(size=(4, m)).astype(np.float32), 3
    raise KeyError(name)


CASES = ["ties_across_kth", "all_equal", "inf", "signed_zeros", "coarse_m1",
         "coarse_m5", "coarse_m7", "coarse_m13", "coarse_m4981", "drawn_m3",
         "drawn_m14943"]


# --------------------------------------------------------------------- #
# the plain version and the wrapper, on the CPU
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", CASES)
def test_plain_version_is_the_stable_sort(case):
    x, k = rows_case(case)
    x = torch.tensor(x)
    before = topk_rows.launches
    R = topk_kernel.ROUND_K
    for kk in sorted({1, k, x.shape[1], x.shape[1] + 2, R, R + 1, 2 * R + 3}):
        got = topk_rows(x, kk)
        want = sort_cut(x, kk)
        for a, b in zip(got, want):
            assert same_bits(a, b.contiguous()), (case, kk)
            assert a.is_contiguous()
        for a, b in zip(topk_rows_ref(x, kk), want):
            assert same_bits(a, b.contiguous())
    assert topk_rows.launches == before
    assert "topk" not in tbuild._LIBS


@pytest.mark.parametrize("case", CASES)
def test_plain_version_is_lax_top_k(case):
    """The JAX package's order, tie for tie.  One difference is pinned: on a
    tie of +0.0 and -0.0, XLA's top-k on the CPU takes +0.0 first (it
    compares the floats' bits), where the sort and the kernel keep index
    order, as the card's sort does (-0.0 == +0.0)."""
    import jax
    x, k = rows_case(case)
    lax_v, lax_i = (np.asarray(a) for a in jax.lax.top_k(x, k))
    values, idx = topk_rows(torch.tensor(x), k)
    assert np.array_equal(values.numpy(), lax_v)      # as floats: -0.0 == +0.0
    if case != "signed_zeros":
        assert np.array_equal(idx.numpy(), lax_i)
        assert np.array_equal(np.signbit(values.numpy()), np.signbit(lax_v))
        return
    assert idx.tolist() == [[0, 1, 3, 4], [0, 1, 2, 3], [5, 2, 1, 3]]
    assert lax_i.tolist() == [[1, 4, 0, 3], [0, 2, 5, 1], [5, 2, 3, 1]]


def test_topk_lax_order_dispatch(monkeypatch):
    """``topk_lax_order`` takes the operator for every device and every
    ``k`` (here fake CUDA tensors, through the operator's fake
    implementation, and a CPU tensor); another dtype raises rather than
    sort."""
    calls = []
    real = topk_kernel.topk_rows

    def spy(x, k):
        calls.append((x.device.type, k))
        return real(x, k)
    monkeypatch.setattr(topk_kernel, "topk_rows", spy)
    big = topk_kernel.ROUND_K + 1
    with FakeTensorMode():
        x = torch.empty(6, 14943, device="cuda")
        for k in (1, 3, big):
            v, i = beam.topk_lax_order(x, k)
            assert v.shape == (6, k) and i.shape == (6, k) and i.dtype == torch.long
        s, f = beam.beam_topk(torch.empty(4, 3, 4981, device="cuda"), 3)
        assert s.shape == f.shape == (4, 3)
    assert calls == [("cuda", 1), ("cuda", 3), ("cuda", big), ("cuda", 3)]
    calls.clear()
    x = torch.randn(4, 30)
    for k in (3, big):
        assert all(torch.equal(a, b) for a, b in zip(beam.topk_lax_order(x, k),
                                                      sort_cut(x, k)))
    assert calls == [("cpu", 3), ("cpu", big)]
    with pytest.raises(TypeError):
        beam.topk_lax_order(x.double(), 3)


def step_case(V=11, N=3, B=3, D=4, seed=0):
    """A tiny deterministic step function over a linear 'decoder', each
    beam started from its own state."""
    g = torch.Generator().manual_seed(seed)
    W = torch.randn(D, V, generator=g) * 3
    E = torch.randn(V, D, generator=g)

    def step(state, words, t):
        h = torch.tanh(state + E[words])
        return h @ W, h
    return step, torch.randn(N * B, D, generator=g), N


@pytest.mark.parametrize("row0", [False, True], ids=["flat", "row0"])
def test_beam_search_sees_a_replaced_beam_topk(row0):
    """``portbench/faults.py`` plants its faults by ``setattr(beam,
    "beam_topk", ...)``: the search looks the function up at each step.  On
    the CPU the kernel never launches."""
    step, init, N = step_case()
    cfg = BeamConfig(beam_size=3, max_length=6, first_step_row0=row0)
    before = topk_rows.launches
    want = batched_beam_search(step, init, N, cfg)
    seen = []
    real = beam.beam_topk

    def replaced(total, k):
        seen.append(tuple(total.shape))
        s, idx = real(total, k)
        return s, idx.flip(-1)                      # a planted fault
    beam.beam_topk = replaced
    try:
        got = batched_beam_search(step, init, N, cfg)
    finally:
        beam.beam_topk = real
    assert seen == [(N, 3, 11)] * (cfg.max_length - int(row0))
    assert not torch.equal(got["seqs"], want["seqs"])
    assert torch.equal(batched_beam_search(step, init, N, cfg)["seqs"], want["seqs"])
    assert topk_rows.launches == before


@pytest.mark.parametrize("shape,k", [((4, 14943), 3), ((2, 3), 8), ((1, 5), 16),
                                     ((2, 40), 33), ((0, 9), 3), ((3, 7), 0)])
def test_fake_gives_shapes_and_dtypes(shape, k):
    x = torch.randn(shape)
    with FakeTensorMode():
        for dev in ("cpu", "cuda"):
            v, i = topk_rows_op(torch.empty(shape, device=dev), k)
            kc = min(k, shape[1])
            assert v.shape == (shape[0], kc) and v.dtype == torch.float32
            assert i.shape == (shape[0], kc) and i.dtype == torch.int64
            assert v.device.type == i.device.type == dev
    torch.library.opcheck(topk_rows_op, (x, k))


def test_wrapper_checks_inputs():
    x = torch.randn(4, 9)
    with pytest.raises(TypeError):
        topk_rows(x.double(), 3)
    with pytest.raises(TypeError):
        topk_rows(x.bfloat16(), 3)
    with pytest.raises(ValueError):
        topk_rows(x[None], 3)
    with pytest.raises(ValueError):
        topk_rows(x, -1)
    with pytest.raises(ValueError, match="unsupported device"):
        topk_rows(x.to("meta"), 3)                  # no silent path


# --------------------------------------------------------------------- #
# the kernel, on a card
# --------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the kernel has no CPU "
                    "mode; chip_smoke.py checks it on the card)")


def on_card(rows):
    return torch.tensor(rows, device="cuda")


def check_against_sort(x, k, what):
    """Bit for bit the card's sort, in one launch a ROUND_K keys."""
    before = topk_rows.launches
    got = topk_rows(x, k)
    rounds = -(-min(k, x.shape[1]) // topk_kernel.ROUND_K)
    assert topk_rows.launches == before + rounds
    want = sort_cut(x, k)
    for a, b in zip(got, want):
        assert same_bits(a, b.contiguous()), (what, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 8, 16, 17, 40])
@pytest.mark.parametrize("M", [14943, 4981, 3])
@pytest.mark.parametrize("R", [1, 7, 512, 1536])
def test_kernel_matches_the_card_sort(card, R, M, k):
    g = torch.Generator("cuda").manual_seed(R * 100003 + M * 17 + k)
    drawn = torch.randn((R, M), generator=g, device="cuda")
    coarse = torch.round(drawn * 2) / 2                          # many ties
    check_against_sort(drawn, k, "drawn")
    check_against_sort(coarse, k, "coarse")


def planted(M, seed):
    """Rows of M scores (M = B * V for some), drawn, with ties across beams,
    +-inf, +-0.0, and NaN of both signs planted among the leaders."""
    g = np.random.default_rng(seed)
    x = (np.round(g.normal(size=(12, M)) * 2) / 2).astype(np.float32)
    b = 3 if M % 3 == 0 else 1
    V = M // b
    x[0] = np.tile(x[0, :V], b)[:M] if b > 1 else x[0]           # every beam the same
    x[1] = -np.inf
    x[1, g.choice(M, min(M, 5), replace=False)] = np.inf
    x[2] = np.where(g.random(M) < 0.5, 0.0, -0.0).astype(np.float32)
    x[3, :] = -1.0
    x[3, g.choice(M, min(M, 4), replace=False)] = -0.0
    x[3, g.choice(M, min(M, 4), replace=False)] = 0.0
    x[4, g.choice(M, min(M, 3), replace=False)] = np.nan
    neg_nan = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    x[5, g.choice(M, min(M, 3), replace=False)] = neg_nan
    x[6] = np.nan
    x[6, g.choice(M, min(M, 2), replace=False)] = neg_nan
    x[7, g.choice(M, min(M, 2), replace=False)] = np.inf
    x[7, g.choice(M, min(M, 2), replace=False)] = np.nan
    other_nan = np.array([0x7FFFFFFF], np.uint32).view(np.float32)[0]
    x[8, g.choice(M, min(M, 3), replace=False)] = other_nan
    x[8, g.choice(M, min(M, 3), replace=False)] = np.nan
    x[9] = x[9].max()                                             # all equal
    x[10, :] = -np.inf
    x[11] = -x[11]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("M", [14943, 4981, 4097, 4096, 1000, 129, 128, 7, 3, 1])
def test_kernel_matches_the_card_sort_on_planted_values(card, M):
    x = on_card(planted(M, seed=M))
    for k in (1, 2, 3, 8, 16, 17, 40):
        for r in range(x.shape[0]):
            check_against_sort(x[r:r + 1].contiguous(), k, f"row {r}")
        check_against_sort(x, k, "all rows")


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    x = torch.randn(6, 40, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        topk_rows(x.t(), 3)
    with pytest.raises(TypeError):
        topk_rows(x.half(), 3)
    before = topk_rows.launches
    v, i = topk_rows(x[:0], 3)
    assert v.shape == (0, 3) and topk_rows.launches == before
    # topk_lax_order hands it a contiguous copy of a strided view
    total = torch.randn(5, 3, 41, device="cuda")
    for a, b in zip(beam.topk_lax_order(total[:, 0], 3), sort_cut(total[:, 0], 3)):
        assert same_bits(a, b.contiguous())


@pytest.mark.cuda
def test_int8_flagship_beam_batch_through_the_kernel(card, monkeypatch):
    """The flagship's int8 decode at batch 512 (beam 3, 20 steps): the same
    seqs and scores through the kernel as through the sort, and 20
    launches a batch."""
    from acvae_tpu_torch.configs import FLAGSHIP_CONF
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.models.quant import (int8_decode_fn, quant_encoder_for,
                                              scheme_kwargs)

    conf = copy.deepcopy(FLAGSHIP_CONF)
    torch.manual_seed(7)
    model = build_model(conf, 4981, 64, device="cuda")
    quant = quant_encoder_for(conf, model, **scheme_kwargs("v2sym"))
    decode = int8_decode_fn(model, quant, decode_method="beam", beam_size=3,
                            max_length=20)
    g = torch.Generator("cuda").manual_seed(11)
    feats = torch.randn((512, 1024, 64), generator=g, device="cuda")
    lens = torch.randint(512, 1025, (512,), generator=g, device="cuda")

    def run():
        return decode(feats, lens, generator=torch.Generator("cuda").manual_seed(3))
    before = topk_rows.launches
    got = run()
    assert topk_rows.launches == before + 20
    monkeypatch.setattr(beam, "topk_lax_order", sort_cut)
    want = run()
    assert topk_rows.launches == before + 20
    assert torch.equal(got["seqs"], want["seqs"])
    assert same_bits(got["scores"], want["scores"])
