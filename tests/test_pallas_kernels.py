"""Fused GPU rejection stack (Triton route) — interpret-mode parity on
the CPU, the kernel-or-plain choice, and the plain path of the rejections
that have no fused kernel.

Tests marked ``gpu`` compile the kernel for the card and skip elsewhere;
``chip_smoke.py`` runs them on an NVIDIA GPU."""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from siriltpu.ops.pallas import reject_stack as rs
from siriltpu.ops.rejection import (_gsl_median, masked_median,
                                    reject_and_mean, sort_axis0)
from siriltpu.verify.oracle import c_reject_block

FRAME_COUNTS = [2, 3, 4, 5, 7, 12, 25, 50, 64, 100]


def _stack_data(f, p, seed, lo=900, hi=1100, degenerate_every=31):
    """Noise around a sky level with hot and cold outliers, real 65535
    values, and a few columns spread so wide that the sigma scan hits the
    reference's mid-scan break (the degenerate path)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(lo, hi, size=(f, p)).astype(np.uint16)
    vals[1 % f, ::4] = 60000
    vals[3 % f, 2::7] = 0
    vals[: min(2, f), ::11] = 65535
    for c in range(0, p, degenerate_every):
        vals[:, c] = np.geomspace(1, 65535, f).astype(np.uint16)
    return vals


def _plain_median(vals):
    f, p = vals.shape
    sv = sort_axis0(jnp.asarray(vals).astype(jnp.float32))
    return np.asarray(_gsl_median(sv, jnp.ones((f, p), bool),
                                  jnp.full((p,), f, jnp.int32)
                                  ).astype(jnp.uint16))


def _assert_all_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ------------------------------------------------ interpret-mode parity

@pytest.mark.parametrize("F", [f for f in FRAME_COUNTS if f >= 5])
def test_fused_sigma_matches_plain(F):
    """Mean AND counters equal the plain hybrid at every frame count the
    kernel takes; P = 300 is not a multiple of BLOCK, so the last program
    runs with masked columns."""
    vals = jnp.asarray(_stack_data(F, 300, seed=100 + F))
    got = rs.fused_stack(vals, "sigma", 2.5, 2.5, interpret=True)
    want = reject_and_mean(vals, "sigma", (2.5, 2.5), fused=False)
    _assert_all_equal(got, want)


@pytest.mark.parametrize("F", FRAME_COUNTS)
def test_fused_median_matches_plain(F):
    """The GSL sorted median (mean of the two middle order statistics,
    C-truncated to WORD), odd and even frame counts, extreme columns."""
    vals = _stack_data(F, 200, seed=200 + F, lo=0, hi=65536)
    vals[:, 0] = 0
    vals[:, 1] = 65535
    mean, rejl, rejh = rs.fused_stack(jnp.asarray(vals), "median",
                                      interpret=True)
    np.testing.assert_array_equal(np.asarray(mean), _plain_median(vals))
    assert not np.asarray(rejl).any() and not np.asarray(rejh).any()


@pytest.mark.parametrize("every,P", [(17, 256), (2, 700)])
def test_fused_sigma_degenerate_fixup(every, P):
    """Columns engineered to hit the reference's mid-scan break
    (N - r <= 4) are flagged by the kernel and re-run through the exact
    masked kernel: the result equals the plain hybrid bit for bit, also
    when more than DEGEN_K pixels need the fix-up (several passes)."""
    F = 25
    vals = jnp.asarray(_stack_data(F, P, seed=9, lo=1000, hi=1100,
                                   degenerate_every=every))
    _, degen, _, _ = rs._fused_raw(vals, "sigma", 2.5, 2.5, True)
    ndeg = int((np.asarray(degen) != 0).sum())
    assert ndeg > 0 and (ndeg > rs.DEGEN_K) == (every == 2), ndeg
    got = rs.fused_stack(vals, "sigma", 2.5, 2.5, interpret=True)
    _assert_all_equal(got, reject_and_mean(vals, "sigma", (2.5, 2.5),
                                           fused=False))


def test_fused_sigma_without_degenerate_pixels():
    """Pure noise: no pixel is degenerate, the fix-up gathers nothing,
    and the window result stands on its own."""
    F, P = 25, 384
    rng = np.random.default_rng(3)
    vals = jnp.asarray(rng.integers(1000, 1200, (F, P)).astype(np.uint16))
    _, degen, _, _ = rs._fused_raw(vals, "sigma", 3.0, 3.0, True)
    assert not np.asarray(degen).any()
    got = rs.fused_stack(vals, "sigma", 3.0, 3.0, interpret=True)
    _assert_all_equal(got, reject_and_mean(vals, "sigma", (3.0, 3.0),
                                           fused=False))


# ------------------------------------------------ the sort network

@pytest.mark.parametrize("F", FRAME_COUNTS + [128])
def test_pruned_network_sorts(F):
    """Dropping every comparator that touches a wire >= F keeps the
    network a sorting network for F values (a wire past F would hold
    +inf, so those comparators were no-ops)."""
    rng = np.random.default_rng(F)
    x = rng.integers(0, 8, size=(F, 512))
    x[:, 0] = np.arange(F)[::-1]
    rows = list(x)
    for a, b in rs._network(F):
        rows[a], rows[b] = np.minimum(rows[a], rows[b]), \
            np.maximum(rows[a], rows[b])
    np.testing.assert_array_equal(np.stack(rows), np.sort(x, axis=0))


# ------------------------------------------------ kernel-or-plain choice

@pytest.mark.parametrize("rejection,F,want", [
    ("sigma", 4, False), ("sigma", 5, True), ("sigma", 100, True),
    ("sigma", rs.F_MAX, True), ("sigma", rs.F_MAX + 1, False),
    ("median", 2, True), ("median", rs.F_MAX + 1, False),
    ("winsorized", 25, False), ("percentile", 25, False),
    ("sigmedian", 25, False), ("linearfit", 25, False)])
def test_fused_applies(rejection, F, want):
    assert rs.fused_applies(rejection, F) is want


@pytest.mark.parametrize("F", [2, 3, 4, rs.F_MAX + 1])
def test_fused_stack_refuses_shapes_it_cannot_take(F):
    with pytest.raises(ValueError):
        rs.fused_stack(jnp.zeros((F, 128), jnp.uint16), "sigma", 3.0, 3.0,
                       interpret=True)


def _lowered(fn, shape, dtype, platform):
    x = jax.ShapeDtypeStruct(shape, dtype)
    return jax.jit(fn).trace(x).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("case,kernel", [
    ("sigma", "fused_sigma_stack"),
    ("sigma_f32", "fused_sigma_stack"),
    ("median", "fused_median_stack"),
    ("sigma_plain", None),
    ("sigma_f4", None),
    ("winsorized", None),
])
def test_gpu_program_selects_kernel(case, kernel):
    """A program lowered for CUDA runs the fused kernel exactly where it
    applies; the same program lowered for the CPU never contains it, so
    the CPU (and every caller with fused=False) keeps the plain path."""
    fns = {
        "sigma": (lambda v: reject_and_mean(v, "sigma"), 25, jnp.uint16),
        "sigma_f32": (lambda v: reject_and_mean(v, "sigma"), 25,
                      jnp.float32),
        "median": (masked_median, 25, jnp.uint16),
        "sigma_plain": (lambda v: reject_and_mean(v, "sigma", fused=False),
                        25, jnp.uint16),
        "sigma_f4": (lambda v: reject_and_mean(v, "sigma"), 4, jnp.uint16),
        "winsorized": (lambda v: reject_and_mean(v, "winsorized"), 25,
                       jnp.float32),
    }
    fn, F, dtype = fns[case]
    cuda = _lowered(fn, (F, 1000), dtype, "cuda")
    cpu = _lowered(fn, (F, 1000), dtype, "cpu")
    assert "fused_" not in cpu and "sqrt_rn" not in cpu
    if kernel is None:
        assert "fused_" not in cuda
        # the plain path on the card takes IEEE roots for sigma
        assert "sqrt_rn" in cuda
    else:
        assert kernel in cuda


def test_reject_and_mean_on_cpu_is_plain():
    """On the CPU the dispatching entry point returns the plain result."""
    vals = jnp.asarray(_stack_data(12, 500, seed=5))
    _assert_all_equal(reject_and_mean(vals, "sigma", (2.5, 2.5)),
                      reject_and_mean(vals, "sigma", (2.5, 2.5),
                                      fused=False))
    np.testing.assert_array_equal(np.asarray(masked_median(vals)),
                                  np.asarray(masked_median(vals,
                                                           fused=False)))


# ------------------------------------------------ plain path vs the oracle

def _oracle(vals, rejection, sig):
    means, rl, rh = [], [], []
    for c in range(vals.shape[1]):
        surv, crej = c_reject_block(vals[:, c], rejection, sig)
        means.append(int(np.floor(surv.astype(np.float64).sum()
                                  / surv.size + 0.5)) if surv.size else 0)
        rl.append(crej[0])
        rh.append(crej[1])
    return np.array(means), np.array(rl), np.array(rh)


@pytest.mark.parametrize("rejection,F", list(itertools.product(
    ["winsorized", "percentile", "sigmedian"], [2, 3, 4, 5, 12, 25, 64])))
def test_plain_rejection_matches_oracle(rejection, F):
    """The rejections without a fused kernel run the plain path; its mean
    and counters equal the literal C-semantics oracle, degenerate columns
    and tiny stacks included."""
    vals = _stack_data(F, 48, seed=40 + F, lo=800, hi=1200,
                       degenerate_every=13)
    sig = (0.2, 0.2) if rejection == "percentile" else (2.5, 2.5)
    got = reject_and_mean(jnp.asarray(vals).astype(jnp.float32), rejection,
                          sig)
    want = _oracle(vals, rejection, sig)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64), w)


def test_plain_winsorized_config3_frame_count():
    """Config 3's F=1000 winsorized stack runs the plain path; it matches
    the oracle, counters included."""
    rng = np.random.default_rng(55)
    vals = rng.integers(800, 1200, size=(1000, 6)).astype(np.uint16)
    vals[1, ::2] = 60000
    vals[3, 1::3] = 0
    got = reject_and_mean(jnp.asarray(vals).astype(jnp.float32),
                          "winsorized", (3.0, 3.0))
    want = _oracle(vals, "winsorized", (3.0, 3.0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64), w)


# ------------------------------------------------ on the card

@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs it there")


@pytest.mark.gpu
@pytest.mark.parametrize("rejection,F", [("sigma", 25), ("sigma", rs.F_MAX),
                                         ("median", 101)])
def test_compiled_kernel_matches_plain_on_card(gpu, rejection, F):
    """The compiled kernel (no interpreter) against the plain XLA path on
    the same card, P not a multiple of BLOCK."""
    vals = jnp.asarray(_stack_data(F, 4096 * 16 + 37, seed=F))
    if rejection == "sigma":
        got = rs.fused_stack(vals, "sigma", 3.0, 3.0)
        want = reject_and_mean(vals, "sigma", (3.0, 3.0), fused=False)
    else:
        got = rs.fused_stack(vals, "median")[:1]
        want = [masked_median(vals, fused=False)]
    _assert_all_equal(got, want)


@pytest.mark.gpu
def test_sqrt_rn_on_card_matches_ieee(gpu):
    """The card's sqrt_rn equals the correctly rounded CPU square root on
    every input, including the values where XLA's GPU sqrt is 1 ulp low."""
    x = np.random.default_rng(0).uniform(0, 1e9, 1 << 20).astype(np.float32)
    got = np.asarray(rs.sqrt_rn(jnp.asarray(x)))
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(jnp.sqrt(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
