"""K2's plain version (ops/scan.multi_cumsum_i32_plain, which the wrapper
runs on CPU tensors) against the JAX package's Pallas scan in interpret
mode, at the edges of the CUDA kernel's tiles (csrc/scan.cu: 8,192
elements of one channel per block): one element, a tile less one, one
tile, a tile and one, several tiles and 3; at 1 and 16 channels, with
sums that wrap mod 2^32. Exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.ops import scan as jscan
from gaussian_ray_tracing_tpu_torch.ops import scan as tscan

TILE = 8192  # elements of one channel per block of csrc/scan.cu


def _wrapping(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64)
    x[:, ::61] = 2**31 - 1  # runs of large values: the partial sums wrap
    return x.astype(np.int32)


@pytest.mark.parametrize("channels", [1, 16])
@pytest.mark.parametrize("P", [1, TILE - 1, TILE, TILE + 1, 3 * TILE + 3])
def test_plain_scan_matches_jax_at_tile_edges(channels, P):
    x = _wrapping((channels, P), seed=P + channels)
    got = tscan.multi_cumsum_i32(torch.from_numpy(x))  # CPU: the plain version
    assert tscan.multi_cumsum_i32_plain(torch.from_numpy(x)).equal(got)
    want = np.asarray(jscan.multi_cumsum_i32(jnp.asarray(x), interpret=True))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    wide = np.cumsum(x.astype(np.int64), axis=1)
    assert (np.abs(wide) > 2**31).any() or P < TILE  # the long rows wrap
