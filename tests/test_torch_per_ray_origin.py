"""The port's per-ray-origin differentiable march against the JAX package
on the CPU: `march_stream_diff(..., use_kernels=False, quad, origins_t,
t_lo, t_hi, t0)` (plain K1 with saved carries, plain K3) against JAX's
`pallas_march_stream(save_tin=True)` and `pallas_march_bwd` in interpret
mode with the same extras, and the forward-only per-ray-origin quad
response `march(quad=True, origins_t=...)` against
`pallas_march_stream(quad=True, origins_t=...)` in window, key and merge
order.

Setup of tests/test_pallas.py:330-390: a 32x16 camera, random_scene(300,
seed=6), chunk 32, min_transmittance 1e-8; origins jittered 0.05 around
the eye, per-ray windows [0.05 + 0.05 U, 3 + U] and carry-in 0.6 + 0.4 U,
drawn here with numpy from a seed and handed to both packages.

Bars: rgb and t_final atol 2e-5 on all but FWD_TAIL_FRAC of the values
and FWD_TAIL_ABS on those (measured: 3 values of the key-order cases above
2e-5, the largest 2.6e-5) where both sides composite the same colours (key
order; window-order training at SH 0, where both pack them to 10 bits),
else the JAX suite's quad-path bars (PSNR >= 70 dB, max abs <= 1e-2: in
window order at SH 1-3 JAX evaluates the colour through its bf16 hi/lo MXU
split, which can move a 10-bit pack by a step, and the window and merge
renders quantize alpha or colour too); saved carries atol 1e-4; per
written column of
d(pair_feats) max|a - b| <= 1e-3 of the column's largest entry, 2e-3 on
the nine M columns, whose reference algebra cancels in float32. Both sides
leave out the boundary rays (a gaussian's peak alpha within ALPHA_EPS of
alpha_min, in float64) and the sort-boundary rays (an inverted pair of
significant candidates less than one quantization step apart in a chunk
whose window-order training sort fires, `_sort_boundary_rays`): XLA's CPU
backend contracts a + b*c into FMAs where the port rounds each operation,
so such a candidate can pass the gate, or such a pair sort, one way on one
side and the other way on the other. The cotangent is zero on them.""" 

import functools

import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.pallas_renderer import prepare_pair_stream
from gaussian_ray_tracing_tpu.models.tiled import tile_rays
from gaussian_ray_tracing_tpu.ops.pallas_march import pallas_march_bwd, pallas_march_stream
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops import march_bwd as tbwd
from gaussian_ray_tracing_tpu_torch.ops.response import canonical_frames, max_response
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
C = 32
KW = dict(hit_multiplicity=1, max_per_tile=4096, chunk_skip_transmittance=1e-3,
          march_chunk=C, min_transmittance=1e-8)
ALPHA_EPS = 1e-4  # boundary rays: |peak alpha / alpha_min - 1| below this
FWD_ATOL, TIN_ATOL, GRAD_REL, GRAD_REL_M = 2e-5, 1e-4, 1e-3, 2e-3
FWD_TAIL_FRAC, FWD_TAIL_ABS = 0.005, 5e-5  # forward values above FWD_ATOL


def _boundary_rays(scene, origins, dirs, alpha_min: float) -> np.ndarray:
    """(T, R) bool: the rays on which some gaussian of the (JAX) scene
    peaks within ALPHA_EPS of alpha_min, from each ray's own origin, in
    float64."""
    f64 = lambda x: torch.from_numpy(np.asarray(x, np.float64)[: scene.num_active])
    means, ops = f64(scene.means), f64(scene.opacities)
    M = canonical_frames(f64(scene.scales), f64(scene.quats))
    o = torch.from_numpy(np.asarray(origins, np.float64).reshape(-1, 1, 3))
    d = torch.from_numpy(np.asarray(dirs, np.float64).reshape(-1, 1, 3))
    near = [(torch.clamp(max_response(means, M, oo, dd)[0] * ops, max=0.99) / alpha_min - 1.0)
            .abs().lt(ALPHA_EPS).any(dim=1) for oo, dd in zip(o.split(1024), d.split(1024))]
    return torch.cat(near).reshape(np.shape(dirs)[:-1]).numpy()


def _sort_boundary_rays(inp) -> np.ndarray:
    """(T, R) bool: the rays of a chunk whose window-order training sort
    fires (ops/march.window_fire) that hold an inverted pair of significant
    candidates (the later one in the stream has the earlier event t) whose
    quantized event t (ops/march.window_tq, before the floor) lie less than
    one step apart: the sort key (tq16 << 8) | src then orders the pair by
    source on one side of a step edge and by t on the other, so float
    rounding (XLA's FMAs) may order it either way. Alpha and event t do not
    depend on the carry, so this is a property of the stream."""
    cfg = RenderConfig(**KW, order="window")
    starts, rows = _t(inp["starts"]), tmarch.train_features(_t(inp["pair_feats"]))
    dirs = _t(inp["dirs_t"])
    dx, dy, dz = dirs.unbind(-1)
    rays = dict(d=[dx, dy, dz], o=list(_t(inp["origins_t"]).unbind(-1)), basis=None,
                live=dx * dx + dy * dy + dz * dz > 0.01, t_lo=_t(inp["t_lo"]),
                t_hi=_t(inp["t_hi"]))
    T, R = dx.shape
    out = np.zeros((T, R), bool)
    counts = (starts[1:] - starts[:-1]).tolist()
    for t in range(T):
        tb = torch.tensor([t])
        sub = {k: [x[tb][:, None] for x in v] if isinstance(v, list)
               else v[tb][:, None] if torch.is_tensor(v) else v for k, v in rays.items()}
        for j in range(-(-counts[t] // C)):
            idx, present = tmarch._chunk_rows(tb, j, starts, C, rows.shape[0], None, 1)
            a, t_ev, _ = tmarch._scalar_alpha(rows[idx], sub, present, cfg)
            if not bool(tmarch.window_fire(a, t_ev)):
                continue
            sig = (a > 0.0)[0]
            lo, hi = float(t_ev[0][sig].min()), float(t_ev[0][sig].max())
            tq = (t_ev[0].double() - lo) * (65534.0 / max(hi - lo, 1e-20))  # (c, R)
            gap = tq[:, None, :] - tq[None, :, :]  # [i, j]: tq_i - tq_j
            later = torch.ones(C, C, dtype=torch.bool).triu(1)[..., None]  # i < j
            pair = later & sig[:, None, :] & sig[None, :, :] & (gap > 0.0) & (gap < 1.0)
            out[t] |= pair.any(dim=(0, 1)).numpy()
    return out


@functools.lru_cache(maxsize=None)
def _stream(degree: int):
    """The JAX pair stream at SH `degree`, the seeded per-ray extras and a
    cotangent that is zero on the boundary rays."""
    scene = j_random_scene(300, seed=6)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=32, height=16)
    cfg = JConfig(**KW, sh_degree=degree)
    stream, pair_feats, _, _ = prepare_pair_stream(scene, cam, cfg, 50_000, C)
    _, dirs, _ = generate_rays(cam, cfg)
    dirs_t = np.array(tile_rays(dirs, 16, 16))
    T, R = dirs_t.shape[:2]
    rng = np.random.default_rng(3)
    eye = np.array(cam.eye, np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    inp = dict(starts=np.array(stream.starts), eye=eye, pair_feats=np.array(pair_feats),
               dirs_t=dirs_t, origins_t=f32(eye + 0.05 * rng.normal(size=(T, R, 3))),
               t_lo=f32(0.05 + 0.05 * rng.uniform(size=(T, R))),
               t_hi=f32(3.0 + rng.uniform(size=(T, R))),
               t0=f32(0.6 + 0.4 * rng.uniform(size=(T, R))))
    keep = ~_boundary_rays(scene, inp["origins_t"], dirs_t, cfg.alpha_min)
    keep &= ~_sort_boundary_rays(inp)
    assert keep.sum() >= 0.99 * keep.size  # a few rays, never a region
    inp["keep"] = keep
    inp["d_rgb"] = f32(rng.normal(size=(T, R, 3)) * keep[..., None])
    inp["d_tfinal"] = f32(rng.normal(size=(T, R)) * keep)
    return inp


EXTRAS = ("origins_t", "t_lo", "t_hi", "t0")


@functools.lru_cache(maxsize=None)
def _jax_train(order: str, degree: int, quad: bool):
    """JAX's march_stream_diff forward (saved carries) and backward with
    every per-ray extra, as its custom_vjp runs them (pallas_march.py
    :1675-1706)."""
    inp = _stream(degree)
    cfg = JConfig(**KW, order=order, sh_degree=degree)
    T, R = inp["dirs_t"].shape[:2]
    ext = {k: inp[k] for k in EXTRAS}
    rgb, t_final, tin, base = pallas_march_stream(
        inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], cfg, n_tiles=T,
        rays_per_tile=R, chunk=C, interpret=True, save_tin=True, quad=quad, **ext)
    d_feats = pallas_march_bwd(
        inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], tin, base, inp["d_rgb"],
        inp["d_tfinal"], cfg, n_tiles=T, rays_per_tile=R, chunk=C, interpret=True,
        origins_t=ext["origins_t"], t_lo=ext["t_lo"], t_hi=ext["t_hi"])
    n = int(np.asarray(base)[-1])
    return (np.asarray(rgb), np.asarray(t_final), np.asarray(tin)[:n, 3, :], np.asarray(base),
            np.asarray(d_feats))


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_forward(got, want, keep, exact: bool):
    for a, b in zip(got, want):
        a = a.detach().numpy()
        assert a.shape == b.shape
        a, b = a[keep], b[keep]
        if exact:
            err = np.abs(a - b)
            assert (err > FWD_ATOL).mean() <= FWD_TAIL_FRAC and err.max() <= FWD_TAIL_ABS
        else:
            assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2


TRAIN_CASES = [("key", 0, False), ("window", 0, False), ("key", 3, False), ("window", 3, False),
               ("key", 0, True)]


@pytest.mark.parametrize("order,degree,quad", TRAIN_CASES)
def test_per_ray_origin_training_march_matches_jax(order, degree, quad):
    """The forward with saved carries (rgb, t_final, carries, chunk_base)
    and the gradient of march_stream_diff, against JAX's kernels."""
    inp = _stream(degree)
    j_rgb, j_t, j_tin, j_base, j_dfeats = _jax_train(order, degree, quad)
    cfg = RenderConfig(**KW, order=order, sh_degree=degree)
    ext = {k: _t(inp[k]) for k in EXTRAS}
    starts, dirs_t, eye = _t(inp["starts"]), _t(inp["dirs_t"]), _t(inp["eye"])

    rows = tmarch.train_features(_t(inp["pair_feats"]), degree)
    rgb, t_final, tin, base = tmarch.march(starts, rows, dirs_t, cfg, C, save_tin=True,
                                           quad=quad, **ext)
    keep = inp["keep"]
    _assert_forward((rgb, t_final), (j_rgb, j_t), keep, exact=order == "key" or degree == 0)
    assert np.array_equal(base.numpy(), j_base)
    row_keep = keep[np.repeat(np.arange(keep.shape[0]), np.diff(j_base))]  # (chunks, R)
    assert np.abs(tin.numpy() - j_tin)[row_keep].max() <= TIN_ATOL
    assert float(t_final.min()) < 0.5  # the stream really composites

    feats = _t(inp["pair_feats"]).requires_grad_(True)
    rgb2, t2 = tbwd.march_stream_diff(tmarch.train_features(feats, degree), starts, dirs_t, eye,
                                      cfg, C, use_kernels=False, quad=quad, **ext)
    assert torch.equal(rgb2, rgb) and torch.equal(t2, t_final)
    (torch.sum(rgb2 * _t(inp["d_rgb"])) + torch.sum(t2 * _t(inp["d_tfinal"]))).backward()
    got = feats.grad.numpy()
    assert np.isfinite(got).all()
    m_cols = range(3, 12)
    for c in sorted(tmarch.diff_columns(degree)):
        b = j_dfeats[:, c]
        bar = GRAD_REL_M if c in m_cols else GRAD_REL
        assert np.abs(got[:, c] - b).max() <= bar * np.abs(b).max(), c
    # every other column, the radius and the quad block among them, gets none
    rest = [c for c in range(got.shape[1]) if c not in tmarch.diff_columns(degree)]
    assert not got[:, rest].any()


@pytest.mark.parametrize("order", ["window", "key", "merge"])
def test_per_ray_origin_quad_render_matches_jax(order):
    """The forward-only per-ray-origin quad response on the training rows
    against pallas_march_stream(quad=True, origins_t=...)."""
    inp = _stream(0)
    cfg = RenderConfig(**KW, order=order)
    T, R = inp["dirs_t"].shape[:2]
    want = pallas_march_stream(
        inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], JConfig(**KW, order=order),
        n_tiles=T, rays_per_tile=R, chunk=C, interpret=True, quad=True,
        origins_t=inp["origins_t"])
    rows = tmarch.train_features(_t(inp["pair_feats"]))
    got = tmarch.march(_t(inp["starts"]), rows, _t(inp["dirs_t"]), cfg, C,
                       origins_t=_t(inp["origins_t"]), quad=True)
    _assert_forward(got, [np.asarray(x) for x in want], inp["keep"], exact=order == "key")
    assert float(got[1].min()) < 0.5
    if order == "key":  # the scalar response of the same rays: other rounding, same order
        scalar = tmarch.march(_t(inp["starts"]), tmarch.scalar_features(_t(inp["pair_feats"])),
                              _t(inp["dirs_t"]), cfg, C, origins_t=_t(inp["origins_t"]))
        _assert_forward(got, [x.numpy() for x in scalar], inp["keep"], exact=False)


def test_origin_centroid_is_the_tile_mean():
    """origin_centroid sums as a halving tree (the kernel's order), for any
    R, and equals the float64 mean to float32 rounding."""
    rng = np.random.default_rng(0)
    for R in (32, 96, 256, 1024):
        x = rng.normal(size=(5, R)).astype(np.float32)
        got = tmarch.origin_centroid(torch.from_numpy(x)).numpy()[:, 0]
        assert np.allclose(got, x.astype(np.float64).mean(axis=1), rtol=0, atol=1e-6)
    x = torch.tensor([[1.0, 2.0, 4.0]])  # n = 3: (1 + 4) + 2
    assert float(tmarch.origin_centroid(x)) == float(np.float32(7.0) / np.float32(3.0))


@pytest.mark.parametrize("order", ["key", "window"])
def test_march_stream_diff_without_extras_is_unchanged(order):
    """Without the new arguments march_stream_diff runs what it ran before
    them: key order on the quad response from the eye, window order on the
    scalar response from per-ray origins each the eye, the backward from
    the shared eye; outputs and gradients bit for bit."""
    inp = _stream(0)
    cfg = RenderConfig(**KW, order=order)
    starts, dirs_t, eye = _t(inp["starts"]), _t(inp["dirs_t"]), _t(inp["eye"])
    feats = _t(inp["pair_feats"]).requires_grad_(True)
    rows = tmarch.train_features(feats)
    rgb, t_final = tbwd.march_stream_diff(rows, starts, dirs_t, eye, cfg, C, use_kernels=False)
    (torch.sum(rgb * _t(inp["d_rgb"])) + torch.sum(t_final * _t(inp["d_tfinal"]))).backward()

    fixed = rows.detach()
    origins = eye.expand(dirs_t.shape).contiguous() if order == "window" else None
    w_rgb, w_t, tin, base = tmarch.march_plain(starts, fixed, dirs_t, cfg, C, save_tin=True,
                                               origins_t=origins)
    assert torch.equal(rgb, w_rgb) and torch.equal(t_final, w_t)
    d_rows = tbwd.march_bwd_plain(starts, fixed, dirs_t, eye, tin, base, _t(inp["d_rgb"]),
                                  _t(inp["d_tfinal"]), cfg, C)
    want = torch.zeros_like(feats)
    for i, c in enumerate(tmarch.TRAIN_COLUMNS):
        if c in tmarch.diff_columns(0):
            want[:, c] += d_rows[:, i]
    assert torch.equal(feats.grad, want)


def test_march_stream_diff_refusals():
    """JAX's refusals (pallas_march.py:1659-1665): merge order does not
    train, quad training needs key order."""
    inp = _stream(0)
    rows = tmarch.train_features(_t(inp["pair_feats"]))
    args = (rows, _t(inp["starts"]), _t(inp["dirs_t"]), _t(inp["eye"]))
    with pytest.raises(ValueError):
        tbwd.march_stream_diff(*args, RenderConfig(**KW, order="merge"), C, use_kernels=False)
    with pytest.raises(ValueError):
        tbwd.march_stream_diff(*args, RenderConfig(**KW, order="window"), C, use_kernels=False,
                               quad=True, origins_t=_t(inp["origins_t"]))


def test_rolling_training_rows_feed_the_differentiable_march():
    """prepare_rolling_stream(train=True): the same stream and rays as the
    scalar rows, training rows that agree with them on every column the
    scalar response reads, and gradients that reach the model's fields
    through march_stream_diff with the per-ray-origin quad response."""
    from gaussian_ray_tracing_tpu_torch.cameras import Camera
    from gaussian_ray_tracing_tpu_torch.models.gaussian_model import FIELDS, GaussianModel
    from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream
    from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene

    cam = lambda x: Camera.create(eye=(x, 0.3, 2.8), lookat=(0.0, 0.0, 0.0), width=48, height=32)
    cfg = RenderConfig(hit_multiplicity=1, order="key", march_chunk=64)
    model = GaussianModel.from_scene(random_scene(400, seed=2)).requires_grad_(True)
    scalar = prepare_rolling_stream(model.activate(), cam(0.0), cam(0.05), cfg,
                                    use_kernels=False)
    train = prepare_rolling_stream(model.activate(), cam(0.0), cam(0.05), cfg,
                                   use_kernels=False, train=True)
    for a, b in zip(scalar[:1] + scalar[2:5], train[:1] + train[2:5]):
        assert torch.equal(a, b)
    assert scalar[5] == train[5] and train[1].shape[1] == tmarch.train_row(0)
    reads = [0] + list(range(tmarch.T_MX, tmarch.TRAIN_ROW))  # op, mean, M, radius, sh0
    assert torch.equal(scalar[1][:, reads], train[1][:, reads])
    starts, rows, dirs_t, origins_t = train[:4]
    rgb, _ = tbwd.march_stream_diff(rows, starts, dirs_t, torch.zeros(3), cfg, 64,
                                    use_kernels=False, quad=True, origins_t=origins_t)
    torch.sum(rgb).backward()
    for f in FIELDS:
        g = getattr(model, f).grad
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0, f
