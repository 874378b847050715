"""paddle_tpu_torch.core.random held against the installed jax.random.

The port's threefry generator works in int64 tensor ops over uint32
words; its keys, folds, splits, bits and uniforms must equal jax's bit
for bit, and its Gumbel noise (torch's log against XLA's) to an ulp.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.core import random as R


def _j(key):
    return np.asarray(key).astype(np.int64)


def _t(key):
    return key.numpy().astype(np.int64)


def test_jax_config_is_the_one_the_port_follows():
    """A jax that changed either setting would change the bits: the port
    follows threefry_partitionable True and the low-range Gumbel."""
    from jax._src import config as jcfg

    assert jax.config.jax_threefry_partitionable is True
    assert jcfg.use_high_dynamic_range_gumbel.value is False


@pytest.mark.parametrize("seed", [0, 1, 11, 42, 2 ** 31 - 1, 2 ** 31,
                                  2 ** 32 - 1, 2 ** 32 + 5, -1, -7])
def test_prngkey_equals_jax(seed):
    np.testing.assert_array_equal(_t(R.PRNGKey(seed, device="cpu")),
                                  _j(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [0, 1, 7, 12345, 2 ** 31 + 3, 2 ** 32 - 1])
def test_fold_in_equals_jax(data):
    for seed in (0, 42):
        want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        got = R.fold_in(R.PRNGKey(seed, device="cpu"), data)
        np.testing.assert_array_equal(_t(got), _j(want))


def test_fold_in_batched_equals_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    pos = np.array([0, 1, 5, 99, 2 ** 20, 7], np.int64)
    want = jax.vmap(jax.random.fold_in)(keys, pos)
    got = R.fold_in(R.as_key(np.asarray(keys), "cpu"),
                    torch.from_numpy(pos))
    np.testing.assert_array_equal(_t(got), _j(want))
    # one key against a vector of data broadcasts like vmap over data
    want = jax.vmap(jax.random.fold_in, (None, 0))(keys[0], pos)
    got = R.fold_in(R.as_key(np.asarray(keys[0]), "cpu"),
                    torch.from_numpy(pos))
    np.testing.assert_array_equal(_t(got), _j(want))


@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_equals_jax(num):
    want = jax.random.split(jax.random.PRNGKey(9), num)
    got = R.split(R.PRNGKey(9, device="cpu"), num)
    assert got.shape == (num, 2)
    np.testing.assert_array_equal(_t(got), _j(want))


def test_split_batched_equals_vmap():
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    want = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    got = R.split(R.as_key(np.asarray(keys), "cpu"), 3)
    np.testing.assert_array_equal(_t(got), _j(want))


@pytest.mark.parametrize("shape", [(), (7,), (3, 128), (8, 50304)])
def test_bits_equal_jax(shape):
    key = jax.random.PRNGKey(42)
    want = jax.random.bits(key, shape, dtype=jnp.uint32)
    got = R.bits(R.PRNGKey(42, device="cpu"), shape)
    assert tuple(got.shape) == shape and got.dtype == torch.int64
    np.testing.assert_array_equal(_t(got), _j(want))


def test_bits_batched_equal_vmap():
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = jax.vmap(lambda k: jax.random.bits(k, (2, 9), jnp.uint32))(keys)
    got = R.bits(R.as_key(np.asarray(keys), "cpu"), (2, 9))
    np.testing.assert_array_equal(_t(got), _j(want))


@pytest.mark.parametrize("shape,lo,hi", [
    ((8, 1000), 0.0, 1.0), ((), 0.0, 1.0), ((5, 33), -2.0, 3.0),
    ((4, 64), float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_equals_jax_bitwise(shape, lo, hi):
    key = jax.random.PRNGKey(17)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
    got = R.uniform(R.PRNGKey(17, device="cpu"), shape, lo, hi).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_gumbel_allclose_jax():
    """torch's and XLA's f32 log may differ by an ulp: rtol 1e-6, and an
    atol of 1e-6 (about one ulp at |g| near 8) for noise near 0, where
    one ulp of the inner log is a large relative change."""
    key = jax.random.PRNGKey(23)
    want = np.asarray(jax.random.gumbel(key, (8, 1000)))
    got = R.gumbel(R.PRNGKey(23, device="cpu"), (8, 1000)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _min_top2_gap(noisy):
    s = np.sort(noisy, axis=-1)
    return float((s[..., -1] - s[..., -2]).min())


def test_categorical_equals_jax_one_key():
    key = jax.random.PRNGKey(31)
    logits = np.random.RandomState(0).randn(16, 500).astype(np.float32) * 3
    noisy = np.asarray(jax.random.gumbel(key, logits.shape)) + logits
    assert _min_top2_gap(noisy) > 1e-5     # no near-tie can hide a flip
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    got = R.categorical(R.PRNGKey(31, device="cpu"),
                        torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def test_categorical_equals_jax_keys_per_row():
    """The serving engine's draw: vmap(categorical(fold_in(key, pos)))."""
    keys = jax.random.split(jax.random.PRNGKey(8), 12)
    pos = np.arange(12) * 5 + 3
    logits = np.random.RandomState(1).randn(12, 300).astype(np.float32) * 2
    fk = jax.vmap(jax.random.fold_in)(keys, pos)
    noisy = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (300,)))(fk)) \
        + logits
    assert _min_top2_gap(noisy) > 1e-5
    want = np.asarray(jax.vmap(jax.random.categorical)(fk,
                                                       jnp.asarray(logits)))
    got = R.categorical(
        R.fold_in(R.as_key(np.asarray(keys), "cpu"), torch.from_numpy(pos)),
        torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def test_categorical_rejects_keys_that_do_not_lead_logits():
    with pytest.raises(ValueError):
        R.categorical(R.split(R.PRNGKey(0, device="cpu"), 3),
                      torch.zeros(4, 10))


def test_words_stay_uint32():
    b = R.bits(R.split(R.PRNGKey(2 ** 32 - 1, device="cpu"), 5), (1000,))
    assert int(b.min()) >= 0 and int(b.max()) < 2 ** 32
    k = R.key_to_numpy(R.fold_in(R.PRNGKey(-1, device="cpu"), 2 ** 32 - 1))
    assert k.dtype == np.uint32


def test_keys_default_to_the_card():
    """A key made with no device named lies on the card, as every entry
    point of the port does; without a card that request raises rather
    than falling back to the CPU."""
    if torch.cuda.is_available():
        assert R.PRNGKey(0).device.type == "cuda"
        assert R.as_key(np.zeros(2, np.uint32)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            R.PRNGKey(0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            R.as_key(np.zeros(2, np.uint32))
    # a tensor key stays where it is
    assert R.as_key(R.PRNGKey(3, device="cpu")).device.type == "cpu"
