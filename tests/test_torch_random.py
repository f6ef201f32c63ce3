"""The port's threefry2x32 generator against ``jax.random``.

Keys, ``split``, ``fold_in``, ``bits``, ``uniform`` and ``bernoulli`` are
integer or exactly-rounded float arithmetic and must match bitwise.
``normal`` runs the same XLA ``erf_inv`` polynomial, but ``log1p`` and the
polynomial's fused multiply-adds may round differently between XLA and
PyTorch, so it is held to a stated ulp bound and the maximum is reported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as jr

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

#: max ulp distance allowed between the port's normals and jax's (see module
#: docstring); the observed maximum is printed by the test
NORMAL_MAX_ULP = 4


def _seeds(n=6):
    """Seeds as the reference takes them: with 64-bit types off a seed is a
    32-bit integer, so negative and >= 2**32 seeds wrap."""
    rng = np.random.default_rng(11)
    return [0, 1, -1, 2**32 + 5, *rng.integers(0, 2**31, size=n - 4).tolist()]


def _key_pair(seed):
    return jax.random.PRNGKey(seed), jr.PRNGKey(seed)


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy().astype(np.uint32), np.asarray(j))


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """ulp distance between two float32 arrays (same sign assumed near 0)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("seed", _seeds())
def test_prngkey_split_fold_in_bitwise(seed):
    kj, kt = _key_pair(seed)
    _eq(kt, kj)
    for num in (2, 3, 4, 7):
        _eq(jr.split(kt, num), jax.random.split(kj, num))
    for data in (0, 1, 7, 12345, 2**31 + 3):
        _eq(jr.fold_in(kt, data), jax.random.fold_in(kj, data))
    # vectorised fold_in over a data vector == vmap(fold_in, (None, 0))
    data = np.arange(9)
    _eq(jr.fold_in(kt, torch.as_tensor(data)),
        jax.vmap(jax.random.fold_in, (None, 0))(kj, jnp.asarray(data)))
    # nested per-(UE, slot) derivation of the slot engine
    ue = jr.fold_in(kt, torch.arange(5))
    _eq(jr.fold_in(ue, 3),
        jax.vmap(lambda u: jax.random.fold_in(jax.random.fold_in(kj, u), 3))(jnp.arange(5)))


@pytest.mark.parametrize("seed", _seeds())
def test_bits_uniform_bernoulli_bitwise(seed):
    kj, kt = _key_pair(seed)
    for shape in ((), (1,), (7,), (3, 5), (2, 3, 4)):
        _eq(jr.bits(kt, shape), jax.random.bits(kj, shape))
        np.testing.assert_array_equal(jr.uniform(kt, shape).numpy(),
                                      np.asarray(jax.random.uniform(kj, shape)))
        np.testing.assert_array_equal(jr.bernoulli(kt, 0.5, shape).numpy(),
                                      np.asarray(jax.random.bernoulli(kj, 0.5, shape)))
    lo, hi = float(np.nextafter(np.float32(-1), np.float32(0))), 1.0
    np.testing.assert_array_equal(
        jr.uniform(kt, (64,), lo, hi).numpy(),
        np.asarray(jax.random.uniform(kj, (64,), jnp.float32, lo, hi)))


def test_vectorised_keys_match_per_key_draws():
    """A (U, 2) key batch draws what U separate jax calls draw."""
    kj, kt = _key_pair(7)
    kjs = jax.random.split(kj, 6)
    kts = jr.split(kt, 6)
    _eq(jr.bits(kts, (4, 3)), jax.vmap(lambda k: jax.random.bits(k, (4, 3)))(kjs))
    np.testing.assert_array_equal(
        jr.uniform(kts, (10,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (10,)))(kjs)))


def test_raw_key_arithmetic():
    """``key + 1`` on the reference's uint32 key, including the wrap."""
    for words in ((0, 0), (0, 2**32 - 1), (2**32 - 1, 2**32 - 1), (5, 2**31)):
        kj = jnp.asarray(words, jnp.uint32)
        kt = jr.as_key(np.asarray(words, np.uint32))
        _eq(jr.add(kt, 1), kj + 1)
        _eq(jr.as_key(np.asarray(kj + 1)), kj + 1)
        np.testing.assert_array_equal(jr.uniform(jr.add(kt, 1), (16,)).numpy(),
                                      np.asarray(jax.random.uniform(kj + 1, (16,))))


@pytest.mark.parametrize("seed", _seeds(8))
def test_normal_within_ulp(seed):
    kj, kt = _key_pair(seed)
    shape = (4096,)
    got = jr.normal(kt, shape).numpy()
    want = np.asarray(jax.random.normal(kj, shape))
    ulp = _ulp(got, want)
    print(f"seed {seed}: max ulp {ulp.max()}, exact share {(ulp == 0).mean():.4f}")
    assert ulp.max() <= NORMAL_MAX_ULP
    assert np.isfinite(got).all()


def test_erf_inv_tails():
    """The polynomial's two branches and the +-1 endpoints."""
    x = np.concatenate([np.linspace(-0.999999, 0.999999, 2001, dtype=np.float32),
                        np.float32([-1.0, 1.0, 0.0])])
    got = jr.erf_inv(torch.as_tensor(x)).numpy()
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x)))
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    assert _ulp(got[finite], want[finite]).max() <= NORMAL_MAX_ULP
    np.testing.assert_array_equal(np.sign(got[~finite]), np.sign(want[~finite]))


# -- the two paths: a CPU key takes the plain form, never the kernel ---------

#: every public draw on a key ``k`` (a (3, 2) batch), and the words it counts
_PUBLIC = {
    "split": (lambda k: jr.split(k, 4), lambda k: jr.split_ref(k, 4), 0),
    "fold_in_int": (lambda k: jr.fold_in(k, 2**31 + 3), lambda k: jr.fold_in_ref(k, 2**31 + 3),
                    0),
    "fold_in_vector": (lambda k: jr.fold_in(k[0], torch.arange(5)),
                       lambda k: jr.fold_in_ref(k[0], torch.arange(5)), 0),
    "bits": (lambda k: jr.bits(k, (2, 5), offset=9), lambda k: jr.bits_ref(k, (2, 5), offset=9),
             30),
    "uniform": (lambda k: jr.uniform(k, (7,), -2.0, 3.0),
                lambda k: jr.uniform_ref(k, (7,), -2.0, 3.0), 21),
    "normal": (lambda k: jr.normal(k, (4, 3)), lambda k: jr.normal_ref(k, (4, 3)), 36),
    "bernoulli": (lambda k: jr.bernoulli(k, 0.3, (11,)), lambda k: jr.bernoulli_ref(k, 0.3, (11,)),
                  33),
    "randint": (lambda k: jr.randint(k, (6,), -4, 99), None, 36),
}


@pytest.mark.parametrize("name", list(_PUBLIC))
def test_cpu_keys_never_load_the_kernel(monkeypatch, name):
    """A CPU key takes the plain form (the path held to ``jax.random``
    above): the kernel library is never asked for, no launch is counted,
    and ``rng.words`` grows by the draw's words."""
    from repro_torch import tracing
    from repro_torch.kernels import build

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU key asked for the threefry kernel")

    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "function", refuse)
    public, plain, words = _PUBLIC[name]
    key = jr.split(jr.PRNGKey(21), 3)
    launches, counted = build.launch_counts["threefry"], tracing.counters["rng.words"]
    got = public(key)
    assert build.launch_counts["threefry"] == launches
    assert tracing.counters["rng.words"] == counted + words
    if plain is not None:
        assert torch.equal(got, plain(key))


def _threefry_scalar(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """threefry2x32 on Python ints, written from the Random123 rounds."""
    m = 0xFFFFFFFF
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    a, b = (x0 + ks[0]) & m, (x1 + ks[1]) & m
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            a = (a + b) & m
            b = (((b << r) | (b >> (32 - r))) & m) ^ a
        a = (a + ks[(i + 1) % 3]) & m
        b = (b + ks[(i + 2) % 3] + i + 1) & m
    return a, b


@pytest.mark.parametrize("offset", [0, 2**32 - 3, 5 * 2**32 + 1])
def test_bits_counter_high_word(offset):
    """Element ``j`` of a draw hashes the counter ``(idx >> 32, idx mod
    2**32)`` of ``idx = offset + j`` (jax's partitionable threefry): at
    offset 0 against ``jax.random.bits`` too, past 2**32 with the high word
    non-zero."""
    kj, kt = _key_pair(77)
    k0, k1 = (int(w) for w in kt)
    want = [np.bitwise_xor(*_threefry_scalar(k0, k1, idx >> 32, idx & 0xFFFFFFFF))
            for idx in range(offset, offset + 6)]
    got = jr.bits(kt, (6,), offset=offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))
    if offset == 0:
        _eq(got, jax.random.bits(kj, (6,)))


def test_kernel_constants_are_the_plain_forms():
    """``csrc/threefry.cu`` spells the erf_inv coefficients and sqrt(2) as
    float32 hex literals: each is the plain form's Python float rounded to
    float32, and the rounds rotate as ``_ROTATIONS`` does."""
    import re
    from pathlib import Path

    src = (Path(jr.__file__).parent / "csrc" / "threefry.cu").read_text()

    def table(name):
        body = re.search(name + r"\[9\] = \{(.*?)\};", src, re.S).group(1)
        return [float.fromhex(v.strip().rstrip("f")) for v in body.split(",")]

    for name, coeffs in (("ERFINV_LT5", jr._ERFINV_LT5), ("ERFINV_GE5", jr._ERFINV_GE5)):
        assert table(name) == [float(np.float32(c)) for c in coeffs], name
    sqrt2 = re.search(r"SQRT2_F32 = (\S+)f;", src).group(1)
    assert float.fromhex(sqrt2) == jr._SQRT2_F32
    rounds = [int(r) for r in re.findall(r"TF_ROUND\((\d+)\)", src.split("hash(")[1])]
    assert rounds == [r for i in range(5) for r in jr._ROTATIONS[i % 2]]
