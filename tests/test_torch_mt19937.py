"""The port's MT19937 (core/mt19937.py) against the JAX package's module and
against numpy's own MT19937, all bitwise.

- ``seed_ref``, ``_twist_np``, ``temper``, ``rand_u32`` and ``rand_float``
  against the JAX module's functions on the same seeds;
- the generation (twist + tempering) against ``np.random.RandomState`` by
  state injection, as tests/test_mt19937.py does it;
- ``twist_torch`` and ``temper_torch`` on the CPU against ``_twist_np``,
  JAX's ``twist_jnp`` and ``temper_jnp``, over chained twists.

The JAX package is imported inside the tests that use it, so that the
``cuda`` test runs on a GPU machine without JAX:
``python -m pytest tests/test_torch_mt19937.py --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.core import mt19937 as P

SEEDS = (0, 1, 5489, 42, P.DEFAULT_SEED, 0xDEADBEEF)


def _i64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_and_draws_match_jax(seed):
    from se195_raytracer_tpu.core import mt19937 as J

    st, jst = P.seed_ref(seed), J.seed_ref(seed)
    np.testing.assert_array_equal(st.mt, jst.mt)
    assert st.mt.dtype == np.uint32 and st.mti == jst.mti == P.N
    np.testing.assert_array_equal(P._twist_np(st.mt), J._twist_np(jst.mt))
    np.testing.assert_array_equal(P.temper(st.mt), J.temper(jst.mt))
    u, st2 = P.rand_u32(st, 1500)  # crosses two twists
    ju, jst2 = J.rand_u32(jst, 1500)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(st2.mt, jst2.mt)
    assert st2.mti == jst2.mti
    f, _ = P.rand_float(st, 700)
    jf, _ = J.rand_float(jst, 700)
    assert f.dtype == np.float32
    np.testing.assert_array_equal(f, jf)


def test_constants_match_jax():
    from se195_raytracer_tpu.core import mt19937 as J

    for name in ("N", "M", "MATRIX_A", "UPPER_MASK", "LOWER_MASK", "DEFAULT_SEED",
                 "FLOAT_SCALE"):
        assert getattr(P, name) == getattr(J, name), name
        assert type(getattr(P, name)) is type(getattr(J, name)), name


@pytest.mark.parametrize("seed", (42, 7))
def test_generation_matches_numpy_mt19937(seed):
    """Same state in, same raw 32-bit stream out as numpy's MT19937."""
    st = P.seed_ref(seed)
    rs = np.random.RandomState()
    rs.set_state(("MT19937", st.mt.astype(np.uint32), int(st.mti)))
    want = rs.randint(0, 2**32, size=2000, dtype=np.uint64).astype(np.uint32)
    got, _ = P.rand_u32(st, 2000)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", (9, 0, 5489))
def test_twist_torch_matches_numpy_and_jnp(seed):
    """Ten chained ``twist_torch`` calls and ``temper_torch`` over each block,
    bitwise ``_twist_np``/``temper`` and JAX's ``twist_jnp``/``temper_jnp``;
    the words come back as int64 in [0, 2**32)."""
    from se195_raytracer_tpu.core import mt19937 as J

    want = P.seed_ref(seed).mt
    got = _i64(want)
    for _ in range(10):
        jnp_twist = np.asarray(J.twist_jnp(want))
        want = P._twist_np(want)
        got = P.twist_torch(got)
        assert got.dtype == torch.int64 and got.shape == (P.N,)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(jnp_twist, want)
        tempered = P.temper_torch(got)
        np.testing.assert_array_equal(tempered.numpy(), P.temper(want).astype(np.int64))
        np.testing.assert_array_equal(np.asarray(J.temper_jnp(want)), P.temper(want))


def test_torch_twin_takes_uint32_words_in_any_integer_type():
    """int32 (negative for the high words) and uint32 inputs give the
    int64 result."""
    mt = P.seed_ref(3).mt
    want = P._twist_np(mt).astype(np.int64)
    np.testing.assert_array_equal(P.twist_torch(torch.from_numpy(mt.view(np.int32))).numpy(), want)
    np.testing.assert_array_equal(P.twist_torch(torch.from_numpy(mt)).numpy(), want)
    np.testing.assert_array_equal(P.temper_torch(torch.from_numpy(mt)).numpy(),
                                  P.temper(mt).astype(np.int64))


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_twist_torch_bitwise_on_cuda():
    """100 chained twists on the card, each block tempered, bitwise numpy."""
    want = P.seed_ref(P.DEFAULT_SEED).mt
    got = _i64(want).cuda()
    for _ in range(100):
        want = P._twist_np(want)
        got = P.twist_torch(got)
        assert torch.equal(P.temper_torch(got).cpu(), _i64(P.temper(want)))
    assert torch.equal(got.cpu(), _i64(want))
