"""Multi-channel int32 prefix sums over the pair stream -- kernel K2
(counterpart of gaussian_ray_tracing_tpu/ops/scan.py).

The binning (ops/tiles.py) broadcasts C per-gaussian int32 columns onto
the ~1-2M-slot pair stream with delta scatters plus inclusive prefix
sums. All sums are exact mod 2^32: deltas wrap and telescope, so any
column, packed bitfields included, round-trips bit for bit.

`multi_cumsum_i32` is the wrapper: a CUDA tensor goes to the hand-written
kernel csrc/scan.cu (replacing the Pallas `_scan_kernel`,
gaussian_ray_tracing_tpu/ops/scan.py:81), a CPU tensor to the plain torch
version `multi_cumsum_i32_plain`, anything else raises.
"""

from __future__ import annotations

import torch

_I32 = torch.int32
MAX_CHANNELS = 16


def multi_cumsum_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch inclusive prefix sum of (C, P) int32 along axis 1.
    cumsum promotes int32 to int64; the cast back wraps mod 2^32."""
    return torch.cumsum(x, dim=1).to(_I32)


def multi_cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of int32 (C, P) along axis 1, C <= 16, exact
    under int32 wraparound. CUDA tensors run kernel K2; CPU tensors run
    the plain version."""
    if x.dim() != 2 or x.dtype != _I32:
        raise ValueError(f"expected (C, P) int32, got {tuple(x.shape)} {x.dtype}")
    if x.shape[0] > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {x.shape[0]}")
    if x.device.type == "cpu":
        return multi_cumsum_i32_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no scan for device {x.device}")
    return _scan_cuda(x.contiguous())


def _scan_cuda(x: torch.Tensor) -> torch.Tensor:
    from gaussian_ray_tracing_tpu_torch.ops.cuda_build import check, load_library

    lib = load_library()
    C, P = x.shape
    y = torch.empty_like(x)
    # status words and the tile counter, zeroed by the library on the stream
    scratch = torch.empty(lib.grt_scan_scratch_bytes(C, P), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grt_multi_cumsum_i32(x.data_ptr(), y.data_ptr(),
                                       scratch.data_ptr(), C, P, stream)
    check(err, "grt_multi_cumsum_i32")
    multi_cumsum_i32.launches += 1
    return y


multi_cumsum_i32.launches = 0


def multi_head_fill(first: torch.Tensor, values: list[torch.Tensor], cap: int,
                    use_kernel: bool = True) -> list[torch.Tensor]:
    """Broadcast C per-owner int32 columns onto the stream in one scan.

    first: (N,) nondecreasing head slot of each owner (<= cap). Each
    channel scatters its value DELTAS at the head slots (zero-count owners
    share their successor's slot, and the scatter-add telescopes their
    deltas) and the fused scan turns deltas into values. use_kernel=False
    runs the plain scan on any device.
    """
    idx = first.to(torch.int64)
    bufs = []
    for v in values:
        v = v.to(torch.int64)
        delta = v - torch.cat([v.new_zeros(1), v[:-1]])
        buf = torch.zeros(cap + 1, dtype=torch.int64, device=v.device)
        bufs.append(buf.index_add_(0, idx, delta)[:cap].to(_I32))  # wraps mod 2^32
    stacked = torch.stack(bufs, dim=0)
    out = multi_cumsum_i32(stacked) if use_kernel else multi_cumsum_i32_plain(stacked)
    return list(out.unbind(0))
