"""The threefry kernel (``csrc/threefry.cu``) behind ``repro_torch.random``
on the card, held bitwise to the plain form on the card: the module's own
``*_ref`` functions and the benchmark's frozen copy
(``arches_bench/reference/prng.py``), which the benchmark's judge runs.

Marked ``cuda``: each skips where there is no NVIDIA GPU, because a CUDA
kernel has no CPU mode.  This file imports no JAX, so it runs on the card's
machine as it is: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_random.py``.
"""

import math

import numpy as np
import pytest
import torch

from arches_bench.reference import prng
from repro_torch import random as jr
from repro_torch import tracing
from repro_torch.kernels import build

#: the slot loop's widest draw: 256 UEs' TX bits (127,200 a UE)
WIDE = (256, 127_200)
#: the smallest float32 above -1
ULP_PM1 = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the threefry kernel has no CPU mode")
    return torch.device("cuda")


def _same(got: torch.Tensor, *wants: torch.Tensor) -> None:
    for want in wants:
        assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
        if got.dtype.is_floating_point:  # bitwise, NaN and the sign of 0 included
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            assert torch.equal(got, want)


def _keys(device, seed=3, n=5):
    """A single key, a (n, 2) batch and a strided (n, 2) slice of a split."""
    one = jr.PRNGKey(seed, device)
    batch = jr.split_ref(one, n)
    return {"one": one, "batch": batch, "slice": jr.split_ref(batch, 4)[:, 2]}


#: public draw -> (kernel call, the module's plain form, the frozen copy's)
DRAWS = {
    "bits": (lambda k, s, **o: jr.bits(k, s, **o), lambda k, s, **o: jr.bits_ref(k, s, **o),
             lambda k, s, **o: prng.bits(k, s, **o)),
    "uniform": (lambda k, s, **o: jr.uniform(k, s, **o),
                lambda k, s, **o: jr.uniform_ref(k, s, **o),
                lambda k, s, **o: prng.uniform(k, s, **o)),
    "uniform_pm1": (lambda k, s, **o: jr.uniform(k, s, ULP_PM1, 1.0, **o),
                    lambda k, s, **o: jr.uniform_ref(k, s, ULP_PM1, 1.0, **o),
                    lambda k, s, **o: prng.uniform(k, s, ULP_PM1, 1.0, **o)),
    "normal": (lambda k, s, **o: jr.normal(k, s, **o), lambda k, s, **o: jr.normal_ref(k, s, **o),
               lambda k, s, **o: prng.normal(k, s, **o)),
    "bernoulli": (lambda k, s: jr.bernoulli(k, 0.5, s), lambda k, s: jr.bernoulli_ref(k, 0.5, s),
                  lambda k, s: prng.bernoulli(k, 0.5, s)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("num", [2, 3, 4, 5, 7])
def test_split_bitwise(cuda, num):
    for key in _keys(cuda).values():
        got = jr.split(key, num)
        _same(got, jr.split_ref(key, num), prng.split(key, num))
        _same(got.cpu(), jr.split_ref(key.cpu(), num))


FOLDS = {
    "scalar": lambda keys, dev: (keys["one"], 7),
    "past_2_31": lambda keys, dev: (keys["one"], 2**31 + 3),
    "batch_scalar": lambda keys, dev: (keys["batch"], 0x9E7),
    "slice_scalar": lambda keys, dev: (keys["slice"], 2**32 + 11),
    "key_vector": lambda keys, dev: (keys["one"], torch.arange(9, device=dev)),
    "batch_vector": lambda keys, dev: (keys["batch"], torch.arange(5, device=dev) * 977),
    "outer": lambda keys, dev: (keys["batch"][:, None], torch.arange(3, device=dev)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FOLDS))
def test_fold_in_bitwise(cuda, case):
    key, data = FOLDS[case](_keys(cuda), cuda)
    got = jr.fold_in(key, data)
    _same(got, jr.fold_in_ref(key, data), prng.fold_in(key, data))
    # the slot engine's nesting: a per-UE key folded with the slot
    _same(jr.fold_in(got, 3), jr.fold_in_ref(jr.fold_in_ref(key, data), 3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(), (1,), (7,), WIDE], ids=["0d", "1", "7", "wide"])
@pytest.mark.parametrize("kind", list(DRAWS))
def test_draw_bitwise(cuda, kind, shape):
    draw, ref, frozen = DRAWS[kind]
    keys = _keys(cuda)
    if shape == WIDE:
        # the slot's form: a key a UE; and one key over the whole shape
        cases = [(jr.split_ref(keys["one"], WIDE[0]), WIDE[1:]), (keys["one"], WIDE)]
    else:
        cases = [(k, shape) for k in keys.values()]
    for key, s in cases:
        got = draw(key, s)
        _same(got, ref(key, s), frozen(key, s))
        del got
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [2**32 - 5, 3 * 2**32 + 11])
@pytest.mark.parametrize("kind", ["bits", "uniform", "normal"])
def test_offset_past_2_32(cuda, kind, offset):
    """The counter's high word is non-zero: it enters the hash."""
    draw, ref, frozen = DRAWS[kind]
    key = _keys(cuda)["batch"]
    got = draw(key, (3, 17), offset=offset)
    _same(got, ref(key, (3, 17), offset=offset), frozen(key, (3, 17), offset=offset))
    assert not torch.equal(got, draw(key, (3, 17), offset=offset + 2**32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bits", "uniform", "normal"])
def test_three_chunks_equal_one_draw(cuda, kind):
    draw = DRAWS[kind][0]
    key = _keys(cuda)["slice"]
    whole = draw(key, (10_007,))
    cuts = ((0, 3_331), (3_331, 6_000), (9_331, 676))
    _same(torch.cat([draw(key, (n,), offset=o) for o, n in cuts], dim=-1), whole)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 2**31 - 1, 4_123_456_789])
def test_normal_bitwise_at_scale(cuda, seed):
    """0 ulp over 256 x 131,072 normals a seed (1.0e8 over the three): the
    card's plain form runs CUDA's log1pf and sqrtf, as the kernel does."""
    keys = jr.split_ref(jr.PRNGKey(seed, cuda), 256)
    got = jr.normal(keys, (131_072,))
    want = jr.normal_ref(keys, (131_072,))
    _same(got, want)
    assert torch.isfinite(got).all()
    del got, want
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_randint_composes_the_kernel(cuda):
    key = _keys(cuda)["batch"]
    got = jr.randint(key, (4, 6), -7, 1_000_003)
    want = jr.randint(key.cpu(), (4, 6), -7, 1_000_003)
    assert torch.equal(got.cpu(), want)


def _calls(dev):
    keys = _keys(dev)
    one, batch, sl = keys["one"], keys["batch"], keys["slice"]
    return [
        (lambda: jr.split(batch, 4), 0),
        (lambda: jr.fold_in(one, torch.arange(6, device=dev)), 0),
        (lambda: jr.fold_in(sl, 17), 0),
        (lambda: jr.bits(sl, (3, 4)), 5 * 12),
        (lambda: jr.uniform(batch, (7,), -2.0, 3.0), 5 * 7),
        (lambda: jr.normal(one, (4, 1272, 3)), 4 * 1272 * 3),
        (lambda: jr.normal(batch, (), offset=2**32), 5),
        (lambda: jr.bernoulli(sl, 0.5, (127,)), 5 * 127),
    ]


@pytest.mark.cuda
def test_one_launch_per_draw_and_the_word_counter(cuda):
    """Each public draw on a CUDA key is one ``threefry`` launch, and
    ``rng.words`` grows by what the same draw on a CPU key adds."""
    for call, words in _calls(cuda):
        launches, counted = build.launch_counts["threefry"], tracing.counters["rng.words"]
        call()
        assert build.launch_counts["threefry"] == launches + 1
        assert tracing.counters["rng.words"] == counted + words
    for call, words in _calls(torch.device("cpu")):
        counted = tracing.counters["rng.words"]
        call()
        assert tracing.counters["rng.words"] == counted + words


@pytest.mark.cuda
def test_every_element_written_under_deterministic_mode(cuda):
    """Deterministic mode fills a new tensor with NaN (an integer's with its
    largest value); the kernel's outputs skip that fill and must still be
    written in full."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert torch.utils.deterministic.fill_uninitialized_memory
        keys = _keys(cuda)
        for kind, (draw, ref, _) in DRAWS.items():
            for shape in ((1,), (7,), (33,), (4, 1272, 14)):
                got = draw(keys["slice"], shape)
                if got.dtype.is_floating_point:
                    assert not torch.isnan(got).any(), kind
                _same(got, ref(keys["slice"], shape))
        for num in (1, 3):
            _same(jr.split(keys["batch"], num), jr.split_ref(keys["batch"], num))
        _same(jr.fold_in(keys["one"], torch.arange(3, device=cuda)),
              jr.fold_in_ref(keys["one"], torch.arange(3, device=cuda)))
        bits = jr.bits(keys["batch"], (1_001,))
        assert int(bits.max()) < 2**32 and int(bits.min()) >= 0
    finally:
        torch.use_deterministic_algorithms(before)


@pytest.mark.cuda
def test_empty_draws_launch_nothing(cuda):
    key = _keys(cuda)["batch"]
    launches = build.launch_counts["threefry"]
    assert jr.bits(key, (0, 3)).shape == (5, 0, 3)
    assert jr.split(key[:0], 2).shape == (0, 2, 2)
    assert build.launch_counts["threefry"] == launches
    assert math.prod(jr.normal(key, (2, 0)).shape) == 0


def _past_axes(draw, key, axes):
    """``draw`` on ``key`` (``axes`` leading axes of 1) whose new keys have
    ``axes + 1`` leading axes."""
    if draw == "split":
        return jr.split(key, 2)
    return jr.fold_in(key, torch.arange(3, device=key.device).view(3, *(1,) * axes))


@pytest.mark.cuda
@pytest.mark.parametrize("draw", ["split", "fold_in"])
def test_new_keys_past_the_kernels_axes_raise(cuda, draw):
    """The key launch indexes at most 8 leading axes: a CUDA key whose new
    keys would have 9 raises, the same key on the CPU takes the plain form,
    and 8 axes are bitwise the plain form's."""
    key = jr.PRNGKey(5, cuda)
    with pytest.raises(ValueError, match="at most 8"):
        _past_axes(draw, key.expand(*(1,) * 8, 2), 8)
    assert _past_axes(draw, key.cpu().expand(*(1,) * 8, 2), 8).dim() == 10
    narrow = key.expand(*(1,) * 7, 2)
    _same(_past_axes(draw, narrow, 7), _past_axes(draw, narrow.cpu(), 7).to(cuda))
