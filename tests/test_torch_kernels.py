"""The port's three kernel modules against ``repro``'s kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against ``repro``'s Pallas kernels run in interpret mode (as ``repro``'s own
tests run them) and against ``repro``'s oracles.  The tests that hold the
hand-written kernels against the plain versions on the card live in
``test_torch_cuda_kernels.py``, which imports no JAX, so the card's machine
can run them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import fit_decision_tree as r_fit
from repro.kernels.mmse_interp import mmse_interp as r_mmse_interp
from repro.kernels.switch_select import switch_select as r_switch_select
from repro.kernels.tree_infer import pack_tree
from repro.kernels.tree_infer import tree_infer as r_tree_infer
from repro.kernels.tree_infer import tree_infer_ref as r_tree_infer_ref
from repro.phy.estimators import WienerInterpolator as RWiener
from repro.phy.nr import SlotConfig as RSlotConfig
from repro_torch.kernels.mmse_interp import mmse_interp
from repro_torch.kernels.switch_select import switch_select, switch_select_batched_ref
from repro_torch.kernels.tree_infer import tree_infer, tree_infer_ref
from repro_torch.phy.estimators import WienerInterpolator
from repro_torch.phy.nr import SlotConfig

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

#: plain Gauss-form interpolation vs the reference kernel: both sum Np float32
#: products per output, in different orders, and the Gauss form's
#: p3 - p1 - p2 cancellation adds the rounding of the largest partial
#: product; the reference's own test holds its kernel to the same bound
MMSE_TOL = dict(rtol=3e-5, atol=3e-5)


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


# -- mmse_interp ---------------------------------------------------------------


@pytest.mark.parametrize("n_prb,lead", [(4, (2, 4, 3)), (24, (2, 4, 3)), (24, (5,))])
def test_mmse_interp_plain_vs_reference_kernel(n_prb, lead, rng):
    w = np.asarray(RWiener.build(RSlotConfig(n_prb=n_prb)).w)
    np.testing.assert_array_equal(WienerInterpolator.build(SlotConfig(n_prb=n_prb), device="cpu").w.numpy(), w)
    h = _cplx(rng, lead + (w.shape[0],))
    want = np.asarray(r_mmse_interp(jnp.asarray(h), jnp.asarray(w)))
    got = mmse_interp(torch.as_tensor(h), torch.as_tensor(w))
    assert got.shape == want.shape and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, **MMSE_TOL)
    # the plain version is the textbook complex product up to rounding
    np.testing.assert_allclose(got.numpy(), h @ w, **MMSE_TOL)


#: the card's kernel against the plain Gauss form (chip_smoke.py, the card
#: tests): Np float32 products per output, the Gauss form's p3 - p1 - p2
#: cancellation, on unit-variance pilots whose outputs are O(10)
KERNEL_MMSE_TOL = 1e-4


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on finite float32: keep 10 mantissa bits, round to
    nearest with ties away from zero (a half-unit carry into the kept bits)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """A float64 rounded toward zero to float32's 24-bit significand, kept in
    float64 (clearing the low 29 mantissa bits of a sign-magnitude float)."""
    return (x.view(torch.int64) & -(1 << 29)).view(torch.float64)


def _interp_3xtf32(h: torch.Tensor, w: torch.Tensor, form: str) -> torch.Tensor:
    """The card kernel's arithmetic, emulated.

    The complex product is one real GEMM ``[Hr Hi] @ [[Wr Wi], [-Wi Wr]]``
    whose k8 step ``j`` holds ``Re h[4j:4j+4]`` then ``Im h[4j:4j+4]``, Np
    zero-padded to the 16-pilot k-tile.  Each operand splits into
    ``hi = tf32(x)`` and ``lo = tf32(x - hi)``.  A ``wgmma`` k8 step is
    modelled as the exact sum of its products and the accumulator, truncated
    to float32 (the tensor core's accumulation does not round to nearest).

    ``"kernel"``: each k-tile starts a fresh accumulator, takes lo*hi and hi*lo
    of its four k8 steps, then their hi*hi, and is added to a float32 sum,
    rounded to nearest.  ``"one_accumulator"``: lo*hi, hi*lo, hi*hi of every
    k8 step into one accumulator over all of k (the kernel's first form).
    ``"single_pass"``: hi*hi alone, one TF32 pass, summed in float32.
    """
    np_, nsc = w.shape
    n = np_ + (-np_) % 16
    hp = torch.nn.functional.pad(h, (0, n - np_))
    wp = torch.nn.functional.pad(w, (0, 0, 0, n - np_))
    a = torch.stack([hp.real.reshape(-1, n // 4, 4), hp.imag.reshape(-1, n // 4, 4)],
                    2).reshape(-1, 2 * n)
    wr, wi = wp.real.reshape(n // 4, 4, nsc), wp.imag.reshape(n // 4, 4, nsc)
    b = torch.stack([torch.cat([wr, wi], 2), torch.cat([-wi, wr], 2)],
                    1).reshape(2 * n, 2 * nsc)
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    if form == "single_pass":
        out = a_hi @ b_hi
        return torch.complex(out[:, :nsc], out[:, nsc:])
    # TF32 x TF32 products and their sums are exact in float64
    a_lo, b_lo = _tf32_rna(a - a_hi).double(), _tf32_rna(b - b_hi).double()
    a_hi, b_hi = a_hi.double(), b_hi.double()
    acc = torch.zeros(h.shape[0], 2 * nsc, dtype=torch.float64)
    total = torch.zeros(h.shape[0], 2 * nsc, dtype=torch.float32)
    for t in range(n // 16):
        ks = [slice(8 * j, 8 * j + 8) for j in range(4 * t, 4 * t + 4)]
        lo = [((a_lo[:, k], b_hi[k]), (a_hi[:, k], b_lo[k])) for k in ks]
        hi = [(a_hi[:, k], b_hi[k]) for k in ks]
        if form == "kernel":
            acc = torch.zeros_like(acc)
            order = [p for pair in lo for p in pair] + hi
        else:
            order = [p for pair, h8 in zip(lo, hi) for p in (*pair, h8)]
        for x, y in order:
            acc = _trunc_f32(torch.addmm(acc, x, y))
        if form == "kernel":
            total += acc.float()
    out = total if form == "kernel" else acc.float()
    return torch.complex(out[:, :nsc], out[:, nsc:])


@pytest.mark.parametrize("rows", [12, 384])
def test_mmse_interp_3xtf32_split_within_tolerance(rows, rng):
    """Why the card kernel splits its operands and sums its k-tiles apart: at
    n_prb 106 its order of arithmetic, emulated with a truncating
    accumulator, stays within the kernel tolerance of ``repro``'s
    mmse_interp; one accumulator over all of k errs several times more, and
    a single TF32 pass misses the tolerance."""
    w = np.asarray(RWiener.build(RSlotConfig(n_prb=106)).w)
    h = _cplx(rng, (rows, w.shape[0]))
    want = np.asarray(r_mmse_interp(jnp.asarray(h), jnp.asarray(w)))
    th, tw = torch.as_tensor(h), torch.as_tensor(w)
    # the rounding rules themselves, both signs
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 3.0], dtype=torch.float32)
    assert _tf32_rna(x).tolist() == [1 + 2**-10, -(1 + 2**-10), 1.0, 3.0]
    y = torch.tensor([1 + 2**-30, -(1 + 2**-23 + 2**-30), 2.0**-40], dtype=torch.float64)
    assert _trunc_f32(y).tolist() == [1.0, -(1 + 2**-23), 2.0**-40]

    def err(form):
        return np.abs(_interp_3xtf32(th, tw, form).numpy() - want).max()

    kernel = err("kernel")
    assert kernel <= KERNEL_MMSE_TOL, kernel
    assert err("one_accumulator") > 5 * kernel
    single = err("single_pass")
    assert single > KERNEL_MMSE_TOL, single
    assert single > 30 * kernel


def test_mmse_interp_wrapper_checks():
    h = torch.zeros(3, 8, dtype=torch.complex64)
    with pytest.raises(ValueError):
        mmse_interp(h, torch.zeros(9, 16, dtype=torch.complex64))
    with pytest.raises(TypeError):
        mmse_interp(h.to(torch.complex128), torch.zeros(8, 16, dtype=torch.complex128))


# -- switch_select ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 4, 1, 72, 3), (3, 7), (4, 2, 5)])
@pytest.mark.parametrize("n_alt", [1, 2])
def test_switch_plain_vs_reference_kernel(shape, n_alt, rng):
    outs = [_cplx(rng, shape) for _ in range(n_alt + 1)]
    modes = rng.integers(0, n_alt + 1, size=shape[0]).astype(np.int32)
    modes[0] = 0
    modes[-1] = n_alt
    want = np.asarray(r_switch_select(jnp.asarray(modes), [jnp.asarray(o) for o in outs]))
    tin = [torch.as_tensor(o) for o in outs]
    got = switch_select(torch.as_tensor(modes), tin)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        switch_select_batched_ref(torch.as_tensor(modes), tin).numpy(), want)
    # on the CPU the plain version leaves its inputs untouched
    np.testing.assert_array_equal(tin[0].numpy(), outs[0])
    # float32 leaves too
    fouts = [o.real.copy() for o in outs]
    np.testing.assert_array_equal(
        switch_select(torch.as_tensor(modes), [torch.as_tensor(o) for o in fouts]).numpy(),
        np.asarray(r_switch_select(jnp.asarray(modes), [jnp.asarray(o) for o in fouts])))


def test_switch_wrapper_checks():
    a = torch.zeros(3, 4)
    with pytest.raises(ValueError):
        switch_select(torch.zeros(2, dtype=torch.int32), [a, a])
    with pytest.raises(ValueError):
        switch_select(torch.zeros(3, dtype=torch.int32), [a, torch.zeros(3, 5)])


# -- tree_infer ------------------------------------------------------------------


def _random_tree(rng, depth, n_feat):
    n_nodes = 2**depth - 1
    feature = rng.integers(0, n_feat, size=n_nodes).astype(np.int32)
    threshold = rng.normal(size=n_nodes).astype(np.float32)
    threshold[rng.random(n_nodes) < 0.3] = np.inf  # pass-through nodes, as the fit emits
    leaves = rng.integers(0, 3, size=2**depth).astype(np.float32)
    return feature, threshold, leaves


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_tree_plain_vs_reference_kernel_and_oracle(depth, rng):
    n_feat = 10
    for trial in range(6):
        x = rng.normal(size=(37, n_feat)).astype(np.float32)
        if trial == 0:  # a fitted tree, as the policy trainer makes them
            y = (x[:, 3] + 0.5 * x[:, 7] > 0).astype(np.int32)
            t = r_fit(x, y, depth=depth)
            feature, threshold, leaves = t.feature, t.threshold, t.leaf_values
        else:
            feature, threshold, leaves = _random_tree(rng, depth, n_feat)
        # values exactly at a threshold go left on every path
        x[0, feature[0]] = threshold[0] if np.isfinite(threshold[0]) else 0.0
        want_walk = np.asarray(r_tree_infer_ref(jnp.asarray(x), jnp.asarray(feature),
                                                jnp.asarray(threshold), jnp.asarray(leaves),
                                                depth))
        want_kernel = np.asarray(r_tree_infer(
            jnp.asarray(x), pack_tree(feature, threshold, leaves, n_feat, depth)))
        args = (torch.as_tensor(feature), torch.as_tensor(threshold), torch.as_tensor(leaves),
                depth)
        got = tree_infer(torch.as_tensor(x), *args).numpy()
        np.testing.assert_array_equal(got, want_walk)
        np.testing.assert_array_equal(got, want_kernel)
        np.testing.assert_array_equal(tree_infer_ref(torch.as_tensor(x), *args).numpy(), got)


def test_tree_infinite_feature_edge_case():
    """Stated difference: with a +-inf feature the reference's dense TPU
    form multiplies inf by 0 in its one-hot projection and goes all-left;
    the port's walk, like ``tree_infer_ref``, follows the feature."""
    feature = np.array([0, 1, 1], np.int32)
    threshold = np.array([0.0, 0.0, 0.0], np.float32)
    leaves = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
    x = np.array([[np.inf, 1.0], [-np.inf, 1.0]], np.float32)
    got = tree_infer(torch.as_tensor(x), torch.as_tensor(feature),
                     torch.as_tensor(threshold), torch.as_tensor(leaves), 2).numpy()
    walk = np.asarray(r_tree_infer_ref(jnp.asarray(x), jnp.asarray(feature),
                                       jnp.asarray(threshold), jnp.asarray(leaves), 2))
    np.testing.assert_array_equal(got, walk)
    np.testing.assert_array_equal(got, [3.0, 1.0])


def test_tree_wrapper_checks():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tree_infer(x, torch.zeros(2, dtype=torch.int32), torch.zeros(3), torch.zeros(4), 2)
    with pytest.raises(ValueError):
        tree_infer(x, torch.zeros(3, dtype=torch.int32), torch.zeros(3), torch.zeros(3), 2)
