"""Merge order (K1's cross-chunk streaming merge) on the port's plain march
against the JAX Pallas march in interpret mode, on the identical pair
streams of tests/test_torch_march.py: the primary render (quad, shared
origin, full range), SH 3, a segment (t_hi, t0) and block mode (bounced
rays). Bars are the K1 bars of that file, >= 70 dB and max abs <= 1e-2 on
rgb and final transmittance; the residual is the TPU kernel's bf16 hi/lo
prefix sums (~2^-16 relative), exp/log ulps, XLA's CPU FMAs on boundary
rays, and equal keys between the pending buffer and a chunk, where the
TPU's bitonic merge duplicates one payload and the port keeps both.

Then the JAX suite's merge tests (tests/test_pallas.py:93-134) on the
port's plain render and its exact oracle, at their own bars, the
refusals, and `cli render --order merge` on the CPU."""

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.ops import blocks as jblocks
from gaussian_ray_tracing_tpu.ops.pallas_march import pallas_march_stream
from gaussian_ray_tracing_tpu_torch import config as tcfg
from gaussian_ray_tracing_tpu_torch.cameras import Camera
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.oracle import render_oracle
from gaussian_ray_tracing_tpu_torch.models.renderer import render
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import psnr
from merge_streams import depth_stream
from test_torch_march import (  # noqa: F401 (module fixtures)
    _assert_march_bars, _jax_march, _segments, _sh_feats, _torch_args, bounce_rays,
    sh_stream_inputs, stream_inputs,
)

torch.set_num_threads(1)
MERGE_SWEEP = [(c, hm, skip) for c in (64, 128, 256) for hm, skip in ((1, 1e-3), (2, 0.02))]


def _merge(**kw):
    return dict(order="merge", **kw)


@pytest.mark.parametrize("chunk,hm,skip", MERGE_SWEEP)
def test_plain_merge_march_matches_pallas(stream_inputs, chunk, hm, skip):
    kw = _merge(hit_multiplicity=hm, march_chunk=chunk, chunk_skip_transmittance=skip)
    want = _jax_march(stream_inputs, kw, chunk, packed16=False)
    before = (tmarch.march.launches, tmarch.march.merge_launches)
    got = tmarch.march_stream(*_torch_args(stream_inputs), RenderConfig(**kw), chunk)
    assert (tmarch.march.launches, tmarch.march.merge_launches) == before  # plain on the CPU
    _assert_march_bars(got, want)
    assert float(got[1].min()) < 0.5
    # the merge really reorders: window order at the same chunk differs
    win = tmarch.march_stream(*_torch_args(stream_inputs),
                              RenderConfig(**{**kw, "order": "window"}), chunk)
    assert psnr(win[0].numpy(), got[0].numpy()) < 90.0


@pytest.mark.parametrize("sh_mxu", [False, True])
def test_plain_merge_sh3_matches_pallas(sh_stream_inputs, sh_mxu):
    """SH 3 per (ray, candidate), through the 3x10-bit pack: the tight K1
    bar against the JAX f32 colour loop (sh_mxu off), and >= 70 dB against
    the TPU kernel's default bf16 hi/lo MXU colour (~4e-6 relative)."""
    inp = {**sh_stream_inputs, "pair_feats": _sh_feats(sh_stream_inputs["pair_feats"], 3)}
    kw = _merge(hit_multiplicity=1, march_chunk=64, sh_degree=3)
    want = _jax_march(inp, {**kw, "sh_mxu": sh_mxu}, 64, packed16=False)
    starts, feats, dirs_t = _torch_args(inp)
    got = tmarch.march(starts, tmarch.compact_features(feats, 3), dirs_t, RenderConfig(**kw), 64)
    if sh_mxu:
        for a, b in zip(got, want):
            assert psnr(a.numpy(), b) >= 70.0
    else:
        _assert_march_bars(got, want)


def test_plain_merge_segment_matches_pallas(stream_inputs):
    """Bounce 0 of the mesh tracer with order="merge": per-ray t_hi and a
    carry-in t0 on the pair stream."""
    _, t_hi, t0 = _segments(stream_inputs, seed=3)
    kw = _merge(hit_multiplicity=1, march_chunk=128)
    want = _jax_march(stream_inputs, kw, 128, packed16=False, t_hi=t_hi, t0=t0)
    starts, feats, dirs_t = _torch_args(stream_inputs)
    got = tmarch.march(starts, tmarch.compact_features(feats), dirs_t, RenderConfig(**kw), 128,
                       t_hi=torch.from_numpy(t_hi), t0=torch.from_numpy(t0))
    _assert_march_bars(got, want)
    assert float(got[1].min()) < 0.2


def test_plain_merge_block_matches_pallas(stream_inputs, bounce_rays):
    """bounce_order="merge": per-ray origins, the scalar response over the
    Morton-sorted table, two blocks per chunk."""
    inp = stream_inputs
    o, d, t_hi, t0 = bounce_rays
    T = d.shape[0]
    chunk, bsub = 64, 2
    index = jblocks.build_block_index(inp["scene"].means, inp["bound"], block_size=chunk)
    table = np.pad(inp["table"][np.asarray(index.perm)], ((0, chunk), (0, 0)))
    bundles = jblocks.bundle_rays(o, d)
    visible = jblocks.cull_blocks(index, bundles, np.max(np.where(d[..., 0] != 0, t_hi, 0), -1))
    bs = jblocks.block_stream(visible, index, bundles, T * chunk * 16, max_per_tile=16)
    kw = _merge(hit_multiplicity=1, march_chunk=chunk)
    want = pallas_march_stream(bs.starts, inp["eye"], table, d, JConfig(**kw), n_tiles=T,
                               rays_per_tile=d.shape[1], chunk=chunk * bsub, interpret=True,
                               origins_t=o, t_hi=t_hi, t0=t0, block_offsets=bs.blk,
                               block_sub=bsub)
    got = tmarch.march(torch.from_numpy(np.array(bs.starts)),
                       tmarch.train_features(torch.from_numpy(table)), torch.from_numpy(d),
                       RenderConfig(**kw), chunk * bsub, origins_t=torch.from_numpy(o),
                       t_hi=torch.from_numpy(t_hi), t0=torch.from_numpy(t0),
                       blocks=torch.from_numpy(np.array(bs.blk)), block_sub=bsub)
    _assert_march_bars(got, [np.asarray(x) for x in want])
    assert float(got[1][d[..., 0] != 0].min()) < 0.5


def test_merge_keys_and_fast_test():
    """Hand cases of the merge key: significant kb with the source index,
    zero-alpha candidates the running max of the significant kb before
    them (INT32_MIN before the first), and the inversion test on kb alone
    (equal kb is no inversion)."""
    t = torch.tensor([[[2.0], [3.0], [1.0], [3.0], [0.5]]])  # (1, 5, 1)
    a = torch.tensor([[[0.0], [0.5], [0.5], [0.0], [0.5]]])
    keys, kb, inv = tmarch.merge_keys(a, t)
    bits = lambda x: int(torch.tensor(x).view(torch.int32)) & ~0xFF
    want = [-(2**31) | 0, bits(3.0) | 1, bits(1.0) | 2, bits(3.0) | 3, bits(0.5) | 4]
    assert keys[0, :, 0].tolist() == want and bool(inv[0])
    _, _, inv = tmarch.merge_keys(torch.tensor([[[0.5], [0.5]]]), torch.tensor([[[1.0], [1.0]]]))
    assert not bool(inv[0])


def test_merge_slow_counter_is_zero_on_a_depth_sorted_stream():
    """march_plain.slow counts the (tile, chunk) pairs whose tile-wide fast
    test fails: none where every tile's candidates ascend in depth and
    chunk j + 1 lies behind chunk j; the count is reset by each call (0
    outside merge order)."""
    chunk = 32
    starts, feats, dirs_t, _ = depth_stream([100, 70], jitter=0.02)
    tmarch.march_plain(starts, feats, dirs_t, RenderConfig(order="merge", march_chunk=chunk),
                       chunk)
    assert (tmarch.march_plain.chunks, tmarch.march_plain.slow) == (7, 0)
    assert tmarch.march_plain.significant > 0
    starts, feats, dirs_t, _ = depth_stream([100, 70], swaps=[(0, 40)])
    tmarch.march_plain(starts, feats, dirs_t, RenderConfig(march_chunk=chunk), chunk)
    assert tmarch.march_plain.slow == 0 and tmarch.march_plain.fired == 1


def test_merge_slow_counter_finds_a_planted_inversion():
    """Candidates 40 and 41 of tile 0 trade places: merge_keys' inversion
    test, on the on-axis rays' alphas and entry t, flags tile 0's chunk 1
    alone, and that is the one slow chunk march_plain counts (the sorted
    chunk then becomes the pending buffer, so chunk 2 is fast again)."""
    chunk, counts, op = 32, [100, 70], 0.02
    starts, feats, dirs_t, t_entry = depth_stream(counts, op=op, swaps=[(0, 40)])
    tmarch.march_plain(starts, feats, dirs_t, RenderConfig(order="merge", march_chunk=chunk),
                       chunk)
    flagged = []
    for t, n in enumerate(counts):
        for j in range(0, n, chunk):
            t_ev = t_entry[int(starts[t]) + j: int(starts[t]) + min(n, j + chunk)][None, :, None]
            if bool(tmarch.merge_keys(torch.full_like(t_ev, op), t_ev)[2][0]):
                flagged.append((t, j // chunk))
    assert flagged == [(0, 1)]
    assert (tmarch.march_plain.chunks, tmarch.march_plain.slow) == (7, len(flagged))


# --- the JAX suite's merge tests on the port (tests/test_pallas.py:93-134) ---

CAM = dict(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
CFG = RenderConfig(hit_multiplicity=1, order="key", max_per_tile=4096,
                   chunk_skip_transmittance=1e-3)
CAP = 200_000


def test_merge_order_beats_window_at_same_chunk():
    """At half the window width (c=64) on the adversarial 3000-gaussian
    scene: merge > 40 dB vs the exact oracle and > window + 1 dB, and
    alpha within 2e-2 of key order (the pending flush loses no opacity)."""
    scene, cam = random_scene(3000, seed=11), Camera.create(**CAM)
    ref = render_oracle(scene, cam, CFG)["rgb"].numpy()
    outs = {order: render(scene, cam, CFG.replace(order=order, march_chunk=64), method="plain",
                          pair_capacity=CAP) for order in ("merge", "window")}
    p = {k: psnr(ref, v["rgb"].numpy()) for k, v in outs.items()}
    key_alpha = render(scene, cam, CFG, method="plain", pair_capacity=CAP)["alpha"].numpy()
    assert p["merge"] > 40.0 and p["merge"] > p["window"] + 1.0, p
    np.testing.assert_allclose(outs["merge"]["alpha"].numpy(), key_alpha, atol=2e-2)


def test_merge_order_is_exact_on_sparse_scene():
    """Every inversion of a spread-out scene fits the 2-chunk repair span:
    the merge reproduces the exact oracle up to the 3x10-bit colour pack
    (1/255.75 steps)."""
    scene, cam = random_scene(300, seed=6, extent=4.0), Camera.create(**CAM)
    ref = render_oracle(scene, cam, CFG)["rgb"].numpy()
    got = render(scene, cam, CFG.replace(order="merge", march_chunk=64), method="plain",
                 pair_capacity=CAP)["rgb"].numpy()
    np.testing.assert_allclose(got, ref, atol=1.1 / 255.75)
    assert psnr(ref, got) > 55.0


def test_merge_refusals_and_config():
    """Merge never trains: saved carries refuse it and training maps it to
    key order; the render and the mesh tracer's bounce_order accept it."""
    starts = torch.zeros(2, dtype=torch.int32)
    dirs_t = torch.zeros((1, 32, 3))
    merge = RenderConfig(order="merge")
    rows = torch.zeros((1, tmarch.train_row(0)))
    for kw in ({}, {"origins_t": torch.zeros((1, 32, 3))}):
        with pytest.raises(ValueError, match="merge"):
            tmarch.march(starts, rows, dirs_t, merge, 128, save_tin=True, **kw)
    assert tcfg.train_config(merge).order == "key"
    assert tcfg.unsupported_fields(merge) == []
    assert tcfg.unsupported_mesh_fields(RenderConfig(bounce_order="merge")) == []
    # oddeven is ported as JAX runs it (stream order, the exact event gate;
    # tests/test_torch_oddeven.py); an order JAX does not have is refused
    assert tcfg.unsupported_mesh_fields(RenderConfig(bounce_order="oddeven")) == []
    assert tcfg.unsupported_mesh_fields(RenderConfig(bounce_order="sorted")) == \
        ["bounce_order='sorted'"]
    rgb, t_final = tmarch.march(starts, torch.zeros((1, tmarch.ROW)), dirs_t,
                                RenderConfig(order="oddeven"), 128)
    assert not rgb.any() and bool((t_final == 1.0).all())  # an empty tile


def test_cli_render_order_merge_on_cpu(tmp_path, capsys):
    from gaussian_ray_tracing_tpu_torch import cli

    out = tmp_path / "merge.png"
    cli.main(["render", "--synthetic", "1500", "--width", "40", "--height", "24", "--order",
              "merge", "--march-chunk", "64", "--hit-multiplicity", "1", "--device", "cpu",
              "-o", str(out)])
    assert out.stat().st_size > 0 and "wrote" in capsys.readouterr().out
