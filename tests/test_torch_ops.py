"""float_torch.ops against their float_tpu.ops twins, in float32 on CPU,
from the same seeded numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float_tpu.ops as J
import float_torch.ops as T
from torch_parity import max_err, randn

ATOL = 1e-5


@pytest.mark.parametrize("shape,bias_shape", [
    ((2, 8, 5, 5), (8,)), ((3, 7, 16), (16,)), ((2, 8, 5, 5), None)])
def test_fused_leaky_relu(shape, bias_shape):
    rng = np.random.default_rng(1)
    x = randn(rng, *shape)
    b = None if bias_shape is None else randn(rng, *bias_shape)
    want = J.fused_leaky_relu(jnp.asarray(x),
                              None if b is None else jnp.asarray(b))
    got = T.fused_leaky_relu(torch.from_numpy(x),
                             None if b is None else torch.from_numpy(b))
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("up,down,pad", [
    (1, 1, (1, 2)), (2, 1, (2, 1)), (1, 2, (1, 1)), (1, 1, (-1, 2)),
    (2, 2, (0, 0))])
def test_upfirdn2d(up, down, pad):
    rng = np.random.default_rng(2)
    x = randn(rng, 2, 3, 9, 9)
    want = J.upfirdn2d(jnp.asarray(x), J.make_blur_kernel((1, 3, 3, 1), up),
                       up=up, down=down, pad=pad)
    got = T.upfirdn2d(torch.from_numpy(x), T.make_blur_kernel((1, 3, 3, 1), up),
                      up=up, down=down, pad=pad)
    assert got.shape == want.shape
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("name", ["upsample2x", "downsample2x"])
def test_resample2x(name):
    rng = np.random.default_rng(3)
    x = randn(rng, 2, 4, 8, 8)
    want = getattr(J, name)(jnp.asarray(x))
    got = getattr(T, name)(torch.from_numpy(x))
    assert got.shape == want.shape
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("bias,lr_mul,activation", [
    (True, 1.0, False), (False, 1.0, False), (True, 0.01, True)])
def test_equal_linear(bias, lr_mul, activation):
    rng = np.random.default_rng(4)
    x, w, b = randn(rng, 3, 5, 16), randn(rng, 12, 16), randn(rng, 12)
    kw = dict(lr_mul=lr_mul, activation=activation)
    want = J.equal_linear(jnp.asarray(x), jnp.asarray(w),
                          jnp.asarray(b) if bias else None, **kw)
    got = T.equal_linear(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b) if bias else None, **kw)
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("k,stride,padding,bias", [
    (3, 1, 1, False), (3, 2, 0, True), (1, 1, 0, True), (4, 1, 0, False)])
def test_equal_conv2d(k, stride, padding, bias):
    rng = np.random.default_rng(5)
    x, w, b = randn(rng, 2, 6, 9, 9), randn(rng, 5, 6, k, k), randn(rng, 5)
    want = J.equal_conv2d(jnp.asarray(x), jnp.asarray(w),
                          jnp.asarray(b) if bias else None, stride, padding)
    got = T.equal_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b) if bias else None, stride,
                         padding)
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("k,demodulate,up,down", [
    (3, True, False, False), (3, True, True, False), (3, False, False, True),
    (1, False, False, False), (3, False, True, False)])
def test_modulated_conv2d(k, demodulate, up, down):
    rng = np.random.default_rng(6)
    x = randn(rng, 2, 6, 8, 8)
    style = randn(rng, 2, 10)
    w = randn(rng, 1, 5, 6, k, k)
    mw, mb = randn(rng, 6, 10), np.ones(6, np.float32)
    args = (x, style, w, mw, mb)
    kw = dict(demodulate=demodulate, up=up, down=down)
    want = J.modulated_conv2d(*map(jnp.asarray, args), **kw)
    got = T.modulated_conv2d(*map(torch.from_numpy, args), **kw)
    assert got.shape == want.shape
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("t,out_len", [(49, 25), (10, 37), (1, 5), (6, 1),
                                       (8, 8)])
def test_linear_interpolate_time(t, out_len):
    x = randn(np.random.default_rng(7), 2, t, 4)
    want = J.linear_interpolate_time(jnp.asarray(x), out_len)
    got = T.linear_interpolate_time(torch.from_numpy(x), out_len)
    assert got.shape == want.shape
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("method", sorted(J.ODE_TABLEAUS))
def test_odeint_fixed(method):
    rng = np.random.default_rng(8)
    a = randn(rng, 4, 4, scale=0.5)
    y0 = randn(rng, 3, 4)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    want = J.odeint_fixed(lambda t, y: (y @ ja.T) * (1.0 + t),
                          jnp.asarray(y0), jnp.linspace(0.0, 1.0, 10),
                          method=method)
    got = T.odeint_fixed(lambda t, y: (y @ ta.T) * (1.0 + t),
                         torch.from_numpy(y0), torch.linspace(0.0, 1.0, 10),
                         method=method)
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("size", [8, 64])
def test_identity_grid(size):
    np.testing.assert_array_equal(np.asarray(J.identity_grid(size)),
                                  T.identity_grid(size).numpy())
