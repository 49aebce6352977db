"""The port's post kernels' plain versions against the JAX package's Pallas
kernels, run in interpret mode on the CPU as tests/test_post.py runs them.

``tonemap_plain`` is the Pallas kernel's own exp/log form and
``gradient_plain`` its reciprocal-multiply form, so both are held to
atol 1e-6 (XLA's CPU log/exp and a possibly contracted multiply-add
against PyTorch's: a few ulp below 1.0).  Inputs come from seeded NumPy.
The dispatchers take the plain versions for CPU tensors; the CUDA kernels
are held against the plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from vk_renderer_tpu.ops import post as jpost
from vk_renderer_tpu_torch.ops import post

import torch_threads  # noqa: F401  (bounds torch's threads)

ATOL = 1e-6


def _hdr(seed, shape):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 8, size=shape).astype(np.float32)
    img.reshape(-1)[:7] = [0.0, 1e-3, 0.5, 1.0, 2.0, 64.0, 1e4]
    return img


@pytest.mark.parametrize("shape", [(3, 64, 128), (3, 72, 96), (3, 5, 7)],
                         ids=["block", "h72", "tiny"])
def test_tonemap_plain_matches_pallas(shape):
    img = _hdr(sum(shape), shape)
    want = np.asarray(jpost.tonemap_pallas(img, interpret=True))
    got = post.tonemap_plain(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the dispatcher runs the plain version on a CPU tensor
    np.testing.assert_array_equal(post.tonemap(torch.from_numpy(img)).numpy(),
                                  got)


def test_tonemap_zero_maps_to_zero():
    z = torch.zeros((3, 8, 16))
    assert bool((post.tonemap_plain(z) == 0).all())
    assert bool((post.tonemap(z) == 0).all())


def test_tonemap_plain_is_the_kernel_form_not_pow():
    """tonemap_xla's pow differs from the exp/log form by up to ~4e-5
    (tests/test_post.py): the plain version follows the kernel."""
    img = torch.from_numpy(_hdr(3, (3, 32, 64)))
    np.testing.assert_allclose(post.tonemap_plain(img).numpy(),
                               post.tonemap_xla(img).numpy(), atol=1e-4)


@pytest.mark.parametrize("h,w,extent_h", [
    (128, 256, None),        # whole 64-row blocks
    (72, 96, None),          # h not a multiple of 64
    (100, 40, 90),           # extent_h < h (padded framebuffer)
    (16, 128, 8),
    (1, 1, None),
])
def test_gradient_plain_matches_pallas_and_xla(h, w, extent_h):
    rng = np.random.default_rng(h * 1000 + w)
    top, bottom = rng.uniform(0, 1, size=(2, 4)).astype(np.float32)
    want = np.asarray(jpost.gradient_pallas(h, w, top, bottom, extent_h,
                                            interpret=True))
    got = post.gradient_plain(h, w, torch.from_numpy(top),
                              torch.from_numpy(bottom), extent_h)
    assert got.shape == (3, h, w) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    xla = jpost.gradient_xla(h, w, top, bottom, extent_h)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(
        post.gradient_xla(h, w, torch.from_numpy(top),
                          torch.from_numpy(bottom), extent_h).numpy(),
        np.asarray(xla), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        post.gradient(h, w, torch.from_numpy(top), torch.from_numpy(bottom),
                      extent_h).numpy(), got.numpy())


def test_cpu_dispatch_launches_no_kernel():
    before = (post.tonemap.launches, post.gradient.launches)
    post.tonemap(torch.ones((3, 4, 4)))
    post.gradient(4, 4, torch.ones(4), torch.zeros(4))
    assert (post.tonemap.launches, post.gradient.launches) == before
