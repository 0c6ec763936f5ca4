"""K1's window-order render options in the port's plain march against the
JAX Pallas march, run as the JAX suite runs it on the CPU (interpret mode,
stats=True), on the identical (starts, pair_feats, dirs_t) of one JAX pair
stream (96x64, 800 gaussians, 16x16 tiles: R = 256, two 128-ray lane
groups), chunk 128 (sort_repair 64 then repairs):

  - composite_scan (the product-form composite) in window, key and merge
    order;
  - sort_lane_groups (the fire test and the key range per 128-ray group);
  - sort_alpha_min = 0.05 with sort_repair 64 (the band sorted alone) and 0
    (the whole list), and with sort_lane_groups.

Bars are tests/test_torch_march.py's: PSNR >= 70 dB and max abs <= 1e-2
on rgb and final transmittance, and the per-tile fired and repaired chunk
counts equal to JAX's. Both sides leave out the sort-boundary rays
(`_sort_boundary_rays`): in a fired group, a pair of significant
candidates whose quantized keys lie less than a step apart, one of them
within EDGE of a step edge, and whose alphas order them against their t.
The sort key tq16 << 15 | a15 orders such a pair by alpha on one side of
the edge and by t on the other, and XLA's FMAs move t by enough to cross
it: with lane groups each group quantizes over its own, narrower range,
and on this stream one ray (tile 10, ray 214) composites one such pair in
the other order in JAX, 0.038 away in green. Left out: 14 of 6,144 rays
with lane groups, 11 without (every chunk of every tile checked, skipped
or not).

Each case also shows what its option does against the default config:
fired or repaired counts that differ from the default's, or (composite_scan)
a final transmittance that differs bitwise. The render-only options leave
the training march's saved carries and K3's gradient bit-identical, as in
JAX (pallas_march.py:775-796, 925-930)."""

import jax
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.pallas_renderer import prepare_pair_stream
from gaussian_ray_tracing_tpu.models.tiled import tile_rays
from gaussian_ray_tracing_tpu.ops.pallas_march import pallas_march_stream
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops import march_bwd as tbwd
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
C = 128
KW = dict(hit_multiplicity=1, march_chunk=C)
T_ = lambda x: torch.from_numpy(np.array(x))
EDGE = 0.05  # sort-boundary rays: a key within this many steps of a step edge


@pytest.fixture(scope="module")
def inp():
    """One JAX pair stream (96x64, 800 gaussians) as numpy arrays, and
    JAX's and the port's default window-order march with its stats."""
    scene = j_random_scene(800, seed=5)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    cfg = JConfig(hit_multiplicity=1)
    prepare = jax.jit(prepare_pair_stream, static_argnums=(2, 3, 4, 5))
    stream, pair_feats, _, _ = prepare(scene, cam, cfg, 65_536, C, False)
    _, dirs, _ = generate_rays(cam, cfg)
    out = dict(starts=np.array(stream.starts), eye=np.array(cam.eye),
               pair_feats=np.array(pair_feats), dirs_t=np.array(tile_rays(dirs, 16, 16)))
    out["jax_default"] = _jax(out, {})
    out["port_default"] = _port(out, {})
    return out


def _jax(inp, kw):
    T, R = inp["dirs_t"].shape[:2]
    cfg = JConfig(**KW, **kw)
    out = pallas_march_stream(inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], cfg,
                              n_tiles=T, rays_per_tile=R, chunk=C, interpret=True, quad=True,
                              packed16=False, stats=cfg.order == "window")
    rgb, t_final = np.asarray(out[0]), np.asarray(out[1])
    stats = tuple(np.asarray(x).astype(np.int64) for x in out[2]) if len(out) > 2 else None
    return rgb, t_final, stats


def _port(inp, kw):
    rgb, t_final, stats = tmarch.march(
        T_(inp["starts"]), tmarch.compact_features(T_(inp["pair_feats"])), T_(inp["dirs_t"]),
        RenderConfig(**KW, **kw), C, stats=True)
    return rgb.numpy(), t_final.numpy(), tuple(x.numpy().astype(np.int64) for x in stats)


def _sort_boundary_rays(inp, kw) -> np.ndarray:
    """(T, R) bool: the rays that, in a chunk where their fire group fires,
    hold two significant candidates whose quantized keys (ops/march.
    window_tq over the group, before the floor) lie less than one step
    apart and whose alphas a15 order them against their keys t (or tie
    them): the render sort key tq16 << 15 | a15 then orders the pair by
    alpha on one side of a step edge and by t on the other, so float
    rounding (XLA's FMAs in t) may order it either way. In every chunk of
    every tile, skipped or not (alpha and t do not depend on the carry)."""
    cfg = RenderConfig(**KW, **kw)
    starts = T_(inp["starts"])
    feats = tmarch.compact_features(T_(inp["pair_feats"]))
    dirs = T_(inp["dirs_t"])
    dx, dy, dz = dirs.unbind(-1)
    rays = dict(d=[dx, dy, dz], o=None, basis=None, live=dx * dx + dy * dy + dz * dz > 0.01,
                t_lo=cfg.t_min, t_hi=cfg.t_max, full_range=True)
    T, R = dx.shape
    opts = tmarch.window_options(cfg, R, C, False)
    G = R // opts["group"]
    out = np.zeros((T, R), bool)
    later = torch.ones(C, C, dtype=torch.bool).triu(1)[..., None]  # [i, j]: i < j
    counts = (starts[1:] - starts[:-1]).tolist()
    for t in range(T):
        tb = torch.tensor([t])
        sub = {k: [x[tb][:, None] for x in v] if isinstance(v, list)
               else v[tb][:, None] if torch.is_tensor(v) else v for k, v in rays.items()}
        for j in range(-(-counts[t] // C)):
            idx, present = tmarch._chunk_rows(tb, j, starts, C, feats.shape[0], None, 1)
            a, t_ev, _ = tmarch._quad_alpha(feats[idx], sub, present, cfg)
            a, t_ev = (tmarch._split_groups(x, G) for x in (a, t_ev))  # (G, c, gw)
            fire = tmarch.window_fire(a, t_ev, opts["a_fire"])
            for g in fire.nonzero().squeeze(1).tolist():
                ag, tg = a[g], t_ev[g].double()  # (c, gw)
                sig = ag > 0.0
                lo, hi = float(tg[sig].min()), float(tg[sig].max())
                tq = (tg - lo) * (65534.0 / max(hi - lo, 1e-20))
                aq = torch.clamp(ag * 32767.0, 0.0, 32767.0).long()
                near = (tq[:, None] - tq[None, :]).abs() < 1.0
                against = (tg[:, None] - tg[None, :]) * (aq[:, None] - aq[None, :]) <= 0
                edge = (tq - tq.round()).abs() < EDGE  # (c, gw): floor may go either way
                pair = later & sig[:, None] & sig[None, :] & near & against \
                    & (edge[:, None] | edge[None, :])
                out[t, g * (R // G):(g + 1) * (R // G)] |= pair.any(dim=(0, 1)).numpy()
    return out


def _assert_bars(got, want, keep=None):
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape
        if keep is not None:
            a, b = a[keep], b[keep]
        assert psnr(a, b) >= 70.0
        assert np.abs(a - b).max() <= 1e-2


@pytest.mark.parametrize("order", ["window", "key", "merge"])
def test_composite_scan_matches_pallas(inp, order):
    """The product form in every order's composite (window: both the
    stream-order and the sorted chunks; merge: the flush too)."""
    want = _jax(inp, dict(composite_scan=True, order=order))
    got = _port(inp, dict(composite_scan=True, order=order))
    _assert_bars(got, want)
    before = tmarch.march.scan_launches
    default = _port(inp, dict(order=order))
    assert tmarch.march.scan_launches == before  # the plain version on the CPU
    assert not np.array_equal(got[1], default[1])  # the product rounds otherwise
    assert float(got[1].min()) < 0.5
    if order == "window":
        assert all(np.array_equal(x, y) for x, y in zip(got[2], want[2]))


def test_default_stats_match_pallas(inp):
    """The per-tile fired and repaired counts of the default config (the
    whole tile one fire group, sort_repair 64 counted) equal JAX's."""
    (jf, jr), (pf, pr) = inp["jax_default"][2], inp["port_default"][2]
    assert np.array_equal(pf, jf) and np.array_equal(pr, jr)
    assert pf.sum() > 0 and pr.sum() > 0  # the stream fires, and repairs
    _assert_bars(inp["port_default"], inp["jax_default"])


@pytest.mark.parametrize("kw,edges", [
    (dict(sort_lane_groups=True), 14),
    (dict(sort_alpha_min=0.05), 11),
    (dict(sort_alpha_min=0.05, sort_repair=0), 11),
    (dict(sort_alpha_min=0.05, sort_lane_groups=True), 14),
])
def test_window_options_match_pallas(inp, kw, edges):
    """Lane groups and the fire-alpha threshold, with and without the span
    repair: the image at the bars, leaving out the tie rays (module
    docstring; their count stated per case), and the counts equal to JAX's
    and different from the default config's."""
    want, got = _jax(inp, kw), _port(inp, kw)
    edge = _sort_boundary_rays(inp, kw)
    assert int(edge.sum()) == edges  # a few rays, never a region
    _assert_bars(got, want, ~edge)
    for x, y in zip(got[2], want[2]):
        assert np.array_equal(x, y)
    default = inp["jax_default"][2]
    assert any(not np.array_equal(x, y) for x, y in zip(want[2], default))
    if kw.get("sort_alpha_min"):  # fewer chunks fire: inversions among tails are ignored
        assert got[2][0].sum() < default[0].sum()


def test_repair_band_sorts_its_window_alone(inp):
    """Under sort_alpha_min the repaired chunks sort only the band's window:
    a candidate out of place among the low-alpha ones outside it keeps its
    stream place. At sort_alpha_min = 0.4 on this stream (at 0.05 no ray
    moves) the band moves rays against the whole-list sort (sort_repair
    0) by more than the bar's residual, and where it does JAX's band moves
    them the same way; both at the bars against JAX."""
    kw = dict(sort_alpha_min=0.4)
    band, whole = _port(inp, kw), _port(inp, {**kw, "sort_repair": 0})
    j_band, j_whole = _jax(inp, kw), _jax(inp, {**kw, "sort_repair": 0})
    for got, want, w in ((band, j_band, kw), (whole, j_whole, {**kw, "sort_repair": 0})):
        _assert_bars(got, want, ~_sort_boundary_rays(inp, w))
        assert all(np.array_equal(x, y) for x, y in zip(got[2], want[2]))
    assert band[2][1].sum() > 0  # some fired chunks repair
    moved = np.abs(band[0] - whole[0]).max(-1)  # (T, R)
    big = moved > 1e-3
    assert big.sum() >= 20
    j_moved = np.abs(j_band[0] - j_whole[0]).max(-1)
    assert (j_moved[big] > 0.5 * moved[big]).all()


@pytest.mark.parametrize("order", ["window", "key"])
def test_render_options_leave_training_unchanged(inp, order):
    """Saved carries: the render-only options are ignored, as in JAX, so the
    training march's outputs and K3's gradient are bit-identical to the
    default config's (window order: the scalar response from the eye)."""
    starts, dirs_t, eye = T_(inp["starts"]), T_(inp["dirs_t"]), T_(inp["eye"])
    rows = tmarch.train_features(T_(inp["pair_feats"]))
    g = torch.Generator().manual_seed(3)
    w = torch.randn(dirs_t.shape, generator=g)
    out = []
    for kw in ({}, dict(composite_scan=True, sort_lane_groups=True, sort_alpha_min=0.05)):
        cfg = RenderConfig(**KW, order=order, **kw)
        r = rows.clone().requires_grad_(True)
        rgb, t_final = tbwd.march_stream_diff(r, starts, dirs_t, eye, cfg, C, use_kernels=False)
        (torch.sum(rgb * w) + torch.sum(t_final)).backward()
        out.append((rgb, t_final, r.grad))
    for x, y in zip(*out):
        assert torch.equal(x, y)
    assert float(out[0][2].abs().max()) > 0


def test_options_reject_what_they_do_not_take(inp):
    starts, dirs_t = T_(inp["starts"]), T_(inp["dirs_t"])
    rows = tmarch.train_features(T_(inp["pair_feats"]))
    with pytest.raises(ValueError, match="stats"):  # stats are render telemetry
        tmarch.march(starts, rows, dirs_t, RenderConfig(**KW, order="key"), C, save_tin=True,
                     stats=True)
    assert tmarch.window_options(RenderConfig(sort_lane_groups=True), 128, C, False)["group"] \
        == 128  # one group: the tile
    opts = tmarch.window_options(RenderConfig(sort_lane_groups=True, sort_alpha_min=0.05,
                                              composite_scan=True), 1024, 64, True)
    assert opts == dict(group=1024, a_fire=0.0, repair=0, scan=False)  # saved carries
    assert tmarch.window_options(RenderConfig(), 256, 64, False)["repair"] == 0  # w < chunk
