"""The port's plain march (the CPU side of kernel K1) against the JAX
Pallas march, run as the JAX suite runs it on the CPU (interpret mode),
on the identical (starts, pair_feats, dirs_t) of one JAX pair stream, in
window order and in key order, with and without saved carries.

The mesh tracer's modes are held the same way: segments (per-ray t_lo or
t_hi and a carry-in t0, window and key order) on the pair stream, and
block mode (per-ray origins, the scalar response on the 32-float training
rows, the Morton-sorted table, block_sub 1 and 2) on bounced rays built
with the JAX package's block index and block stream.

Bars are the JAX suite's own for the quad path (tests/test_pallas.py):
PSNR >= 70 dB and max abs <= 1e-2 on rgb and final transmittance. The
residual comes from the TPU kernel's bf16 hi/lo prefix sums (~2^-16
relative), exp/log ulps, and exact key ties in fired chunks, where the
TPU's bitonic network may duplicate one colour pack.

Saved carries: atol 1e-4 on all but TIN_TAIL_FRAC of the entries, and
TIN_TAIL_ABS on that tail, leaving out the boundary rays: rays on which
some gaussian's peak alpha lies within ALPHA_EPS (relative) of alpha_min,
computed in float64. Both come from XLA's CPU backend contracting a + b*c
into FMAs where the port rounds each operation. The quad response pp = oo
+ od t* cancels from |oo| ~ 1e3..1e4, so alpha differs by up to ~3e-4
relative and the carries behind it by up to ~2e-4 (measured, with 10 of
6,144 rays left out: 34 of 18,631 entries above 1e-4 at c=64, the largest
2.1e-4; 1 of 7,152 at c=256). On a boundary ray the
candidate passes the gate on one side only and every later carry of the
ray moves by about alpha_min * T (the largest 5.45e-4 = 0.01 x 0.0545)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.pallas_renderer import prepare_pair_stream
from gaussian_ray_tracing_tpu.models.tiled import tile_rays
from gaussian_ray_tracing_tpu.ops import blocks as jblocks
from gaussian_ray_tracing_tpu.ops.pallas_march import pallas_march_stream
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.ops.response import canonical_frames, max_response
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
SWEEP = [(c, hm, skip) for c in (64, 128) for hm in (1, 2) for skip in (1e-3, 0.02)]
KEY_SWEEP = [(c, hm, skip) for c in (64, 128, 256) for hm in (1, 2)
             for skip in (1e-3, 0.02)]
ALPHA_EPS = 1e-4  # boundary rays: |peak alpha / alpha_min - 1| below this
TIN_TAIL_FRAC, TIN_TAIL_ABS = 0.005, 3e-4  # saved carries above 1e-4


def _boundary_rays(scene, dirs, eye, alpha_min: float) -> np.ndarray:
    """dirs (..., 3) -> bool (...): the rays on which some gaussian of the
    (JAX) scene peaks within ALPHA_EPS of alpha_min, in float64."""
    f64 = lambda x: torch.from_numpy(np.asarray(x, np.float64)[: scene.num_active])
    means, ops = f64(scene.means), f64(scene.opacities)
    M = canonical_frames(f64(scene.scales), f64(scene.quats))
    d = torch.from_numpy(np.asarray(dirs, np.float64).reshape(-1, 1, 3))
    near = []
    for part in d.split(1024):
        resp, _ = max_response(means, M, torch.tensor(eye, dtype=torch.float64), part)
        near.append((torch.clamp(resp * ops, max=0.99) / alpha_min - 1.0).abs() < ALPHA_EPS)
    return torch.cat(near).any(dim=1).reshape(np.shape(dirs)[:-1]).numpy()


@pytest.fixture(scope="module")
def stream_inputs():
    """One JAX pair stream (96x64, 800 gaussians) as numpy arrays."""
    scene = j_random_scene(800, seed=5)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    cfg = JConfig(hit_multiplicity=1)
    prepare = jax.jit(prepare_pair_stream, static_argnums=(2, 3, 4, 5))
    stream, pair_feats, table, bound = prepare(scene, cam, cfg, 65_536, 128, False)
    _, dirs, _ = generate_rays(cam, cfg)
    return dict(
        starts=np.array(stream.starts), eye=np.array(cam.eye),
        pair_feats=np.array(pair_feats), dirs_t=np.array(tile_rays(dirs, 16, 16)), scene=scene,
        table=np.array(table), bound=np.array(bound),
    )


def _torch_args(inp):
    return (torch.from_numpy(inp["starts"]), torch.from_numpy(inp["pair_feats"]),
            torch.from_numpy(inp["dirs_t"]))


@pytest.mark.parametrize("chunk,hm,skip", SWEEP)
def test_plain_march_matches_pallas(stream_inputs, chunk, hm, skip):
    inp = stream_inputs
    kw = dict(hit_multiplicity=hm, march_chunk=chunk, chunk_skip_transmittance=skip)
    T, R = inp["dirs_t"].shape[:2]
    j_rgb, j_t = pallas_march_stream(
        inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], JConfig(**kw),
        n_tiles=T, rays_per_tile=R, chunk=chunk, interpret=True, quad=True,
        packed16=False,
    )
    j_rgb, j_t = np.asarray(j_rgb), np.asarray(j_t)
    rgb, t_final = tmarch.march_stream(*_torch_args(inp), RenderConfig(**kw), chunk)
    assert rgb.shape == j_rgb.shape and t_final.shape == j_t.shape
    for a, b in ((rgb.numpy(), j_rgb), (t_final.numpy(), j_t)):
        assert psnr(a, b) >= 70.0
        assert np.abs(a - b).max() <= 1e-2
    assert float(t_final.min()) < 0.5  # the stream really composites


def _jax_march(inp, kw, chunk, **extra):
    T, R = inp["dirs_t"].shape[:2]
    out = pallas_march_stream(
        inp["starts"], inp["eye"], inp["pair_feats"], inp["dirs_t"], JConfig(**kw),
        n_tiles=T, rays_per_tile=R, chunk=chunk, interpret=True, quad=True, **extra,
    )
    return [np.asarray(x) for x in out]


def _assert_march_bars(got, want):
    for a, b in zip(got, want):
        a = a.numpy()
        assert a.shape == b.shape
        assert psnr(a, b) >= 70.0
        assert np.abs(a - b).max() <= 1e-2


@pytest.mark.parametrize("chunk,hm,skip", KEY_SWEEP)
def test_plain_key_march_matches_pallas(stream_inputs, chunk, hm, skip):
    """Key order: the sqrt-free full-range gate and the stream-order
    composite, against pallas_march_stream(order="key", quad=True)."""
    kw = dict(hit_multiplicity=hm, march_chunk=chunk, chunk_skip_transmittance=skip,
              order="key")
    want = _jax_march(stream_inputs, kw, chunk, packed16=False)
    rgb, t_final = tmarch.march_stream(*_torch_args(stream_inputs), RenderConfig(**kw), chunk)
    _assert_march_bars((rgb, t_final), want)
    assert float(t_final.min()) < 0.5


@pytest.mark.parametrize("chunk", [64, 256])
def test_saved_carries_match_pallas(stream_inputs, chunk):
    """save_tin: chunk_base equal, every chunk's carry-in T (skipped chunks
    included) against row 3 of the TPU kernel's 8-row panels at atol 1e-4
    but for a bounded tail, on every ray but the boundary rays (module
    docstring)."""
    kw = dict(hit_multiplicity=1, march_chunk=chunk, order="key")
    j_rgb, j_t, j_tin, j_base = _jax_march(stream_inputs, kw, chunk, save_tin=True)
    rgb, t_final, tin, base = tmarch.march_stream(
        *_torch_args(stream_inputs), RenderConfig(**kw), chunk, save_tin=True)
    _assert_march_bars((rgb, t_final), (j_rgb, j_t))
    assert np.array_equal(base.numpy(), j_base)
    n = int(j_base[-1])
    assert tin.shape == (n, stream_inputs["dirs_t"].shape[1])
    inp = stream_inputs
    boundary = _boundary_rays(inp["scene"], inp["dirs_t"], inp["eye"],
                              RenderConfig().alpha_min)  # (T, R)
    assert boundary.sum() <= 0.005 * boundary.size  # a few rays, never a region
    tile = np.repeat(np.arange(len(j_base) - 1), np.diff(j_base))  # tile of each tin row
    err = np.abs(tin.numpy() - j_tin[:n, 3, :])[~boundary[tile]]
    assert np.mean(err > 1e-4) <= TIN_TAIL_FRAC and err.max() <= TIN_TAIL_ABS
    assert float(tin.min()) < 0.5  # later chunks really start from lower T


def test_wrapper_uses_plain_version_on_cpu(stream_inputs):
    starts, feats, dirs_t = _torch_args(stream_inputs)
    compact = tmarch.compact_features(feats)
    assert compact.shape == (feats.shape[0], tmarch.ROW)
    assert torch.equal(compact[:, 0], feats[:, 12])
    assert torch.equal(compact[:, 12:15], feats[:, 77:80])
    before = tmarch.march.launches
    a = tmarch.march(starts, compact, dirs_t, RenderConfig(), 128)
    b = tmarch.march_plain(starts, compact, dirs_t, RenderConfig(), 128)
    assert tmarch.march.launches == before  # no kernel launch on the CPU
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # training rows: the key-order training march reads their first 16
    # columns, the compact row, so it composites what the render march does
    # at the training skip threshold
    rows = tmarch.train_features(feats)
    assert rows.shape == (feats.shape[0], tmarch.TRAIN_ROW)
    assert torch.equal(rows[:, : tmarch.ROW], compact)
    key = RenderConfig(order="key")
    c = tmarch.march(starts, rows, dirs_t, key, 128, save_tin=True)
    d = tmarch.march_plain(starts, rows, dirs_t, key, 128, save_tin=True)
    assert tmarch.march.launches == before and tmarch.march.save_tin_launches == 0
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    e = tmarch.march_plain(starts, compact, dirs_t,
                           key.replace(chunk_skip_transmittance=key.min_transmittance), 128)
    assert torch.equal(c[0], e[0]) and torch.equal(c[1], e[1])


def test_march_rejects_unsupported_arguments(stream_inputs):
    starts, feats, dirs_t = _torch_args(stream_inputs)
    compact = tmarch.compact_features(feats)
    with pytest.raises(NotImplementedError):
        tmarch.march(starts, compact, dirs_t, RenderConfig(), 96)
    with pytest.raises(ValueError):
        tmarch.march(starts, feats, dirs_t, RenderConfig(), 128)  # not compact rows
    with pytest.raises(ValueError):
        tmarch.march(starts[:-1], compact, dirs_t, RenderConfig(), 128)
    with pytest.raises(NotImplementedError):  # window-order training needs per-ray origins
        tmarch.march(starts, compact, dirs_t, RenderConfig(), 128, save_tin=True)
    with pytest.raises(ValueError):  # saved carries take the training rows only
        tmarch.march(starts, compact, dirs_t, RenderConfig(order="key"), 128, save_tin=True)
    # oddeven runs as JAX's kernel runs it: key order's stream-order
    # composite with the exact event gate, which key order itself takes on
    # rays with a window, so it equals key order over [t_min, t_max] windows
    odd = tmarch.march(starts, compact, dirs_t, RenderConfig(order="oddeven"), 128)
    cfg = RenderConfig(order="key")
    lo, hi = (torch.full(dirs_t.shape[:2], v) for v in (cfg.t_min, cfg.t_max))
    want = tmarch.march(starts, compact, dirs_t, cfg, 128, t_lo=lo, t_hi=hi)
    assert torch.equal(odd[0], want[0]) and torch.equal(odd[1], want[1])
    # merge order is ported (tests/test_torch_merge.py); it never trains
    rgb, t_final = tmarch.march(starts, compact, dirs_t, RenderConfig(order="merge"), 128)
    assert rgb.shape == dirs_t.shape and float(t_final.min()) < 0.5
    with pytest.raises(ValueError, match="merge"):
        tmarch.march(starts, tmarch.train_features(feats), dirs_t,
                     RenderConfig(order="merge"), 128, save_tin=True)


def _segments(inp, seed):
    """Per-ray windows and carry-ins for the stream's rays: (t_lo, t_hi, t0)."""
    rng = np.random.default_rng(seed)
    shape = inp["dirs_t"].shape[:2]
    u = lambda lo, hi: rng.uniform(lo, hi, size=shape).astype(np.float32)
    return u(1.5, 3.0), u(1.8, 3.6), u(0.2, 1.0)


@pytest.mark.parametrize("order,window", [("window", "t_hi"), ("window", "t_lo"),
                                          ("key", "t_hi"), ("key", "t_lo")])
def test_plain_segment_march_matches_pallas(stream_inputs, order, window):
    """The pair stream with a per-ray window and a carry-in: bounce 0 of the
    mesh tracer (t_hi at the mesh hit) and the planar mirror's reflected
    frame (t_lo past the mirror); key order then takes the exact gate."""
    inp = stream_inputs
    t_lo, t_hi, t0 = _segments(inp, seed=3)
    seg = {window: t_lo if window == "t_lo" else t_hi, "t0": t0}
    kw = dict(hit_multiplicity=1, march_chunk=128, order=order)
    want = _jax_march(inp, kw, 128, packed16=False, **seg)
    starts, feats, dirs_t = _torch_args(inp)
    got = tmarch.march(starts, tmarch.compact_features(feats), dirs_t, RenderConfig(**kw), 128,
                       **{k: torch.from_numpy(v) for k, v in seg.items()})
    _assert_march_bars(got, want)
    assert float(got[1].min()) < 0.2  # the segments really composite


@pytest.fixture(scope="module")
def bounce_rays(stream_inputs):
    """Rays reflected off a mirror plane at z = 0.3: per-ray origins on the
    plane, mirrored directions, a tenth of them dead, with per-ray t_hi and
    a carry-in."""
    inp = stream_inputs
    d = inp["dirs_t"].astype(np.float64)
    t_plane = (0.3 - inp["eye"][2]) / d[..., 2]
    o = (inp["eye"] + t_plane[..., None] * d).astype(np.float32)
    d_r = d * np.array([1.0, 1.0, -1.0])
    rng = np.random.default_rng(5)
    d_r[rng.uniform(size=d.shape[:2]) < 0.1] = 0.0
    _, t_hi, t0 = _segments(inp, seed=4)
    return o, d_r.astype(np.float32), t_hi + 1.0, t0


@pytest.mark.parametrize("order,chunk,bsub,hm", [("window", 128, 1, 1), ("window", 64, 2, 1),
                                                 ("window", 128, 2, 2), ("key", 128, 1, 1),
                                                 ("key", 64, 2, 2)])
def test_plain_block_march_matches_pallas(stream_inputs, bounce_rays, order, chunk, bsub, hm):
    """Block mode: per-ray origins, the scalar response (quad=False), the
    Morton-sorted table padded by one block of zero rows, block_sub blocks
    per kernel chunk, against pallas_march_stream(block_offsets=...)."""
    inp = stream_inputs
    o, d, t_hi, t0 = bounce_rays
    T, R = d.shape[:2]
    index = jblocks.build_block_index(inp["scene"].means, inp["bound"], block_size=chunk)
    table = np.pad(inp["table"][np.asarray(index.perm)], ((0, chunk), (0, 0)))
    bundles = jblocks.bundle_rays(o, d)
    visible = jblocks.cull_blocks(index, bundles, jnp.max(jnp.where(d[..., 0] != 0, t_hi, 0), -1))
    bs = jblocks.block_stream(visible, index, bundles, T * chunk * 16, max_per_tile=16)
    kw = dict(hit_multiplicity=hm, march_chunk=chunk, order=order)
    T, R = d.shape[:2]
    want = pallas_march_stream(bs.starts, inp["eye"], table, d, JConfig(**kw), n_tiles=T,
                               rays_per_tile=R, chunk=chunk * bsub, interpret=True,
                               origins_t=o, t_hi=t_hi, t0=t0, block_offsets=bs.blk,
                               block_sub=bsub)
    want = [np.asarray(x) for x in want]
    rows = tmarch.train_features(torch.from_numpy(table))
    before = (tmarch.march.launches, tmarch.march.block_launches)
    got = tmarch.march(torch.from_numpy(np.array(bs.starts)), rows, torch.from_numpy(d),
                       RenderConfig(**kw), chunk * bsub, origins_t=torch.from_numpy(o),
                       t_hi=torch.from_numpy(t_hi), t0=torch.from_numpy(t0),
                       blocks=torch.from_numpy(np.array(bs.blk)), block_sub=bsub)
    assert (tmarch.march.launches, tmarch.march.block_launches) == before  # plain on the CPU
    _assert_march_bars(got, want)
    assert float(got[1][d[..., 0] != 0].min()) < 0.5  # bounced rays really composite
    assert np.array_equal(got[1].numpy()[d[..., 0] == 0], t0[d[..., 0] == 0])  # dead rays


def test_block_mode_rejects_what_it_does_not_take(stream_inputs, bounce_rays):
    starts, feats, dirs_t = _torch_args(stream_inputs)
    o = torch.from_numpy(bounce_rays[0])
    compact = tmarch.compact_features(feats)
    with pytest.raises(ValueError):  # per-ray origins need the training rows
        tmarch.march(starts, compact, dirs_t, RenderConfig(), 128, origins_t=o)
    with pytest.raises(ValueError):  # block_sub without blocks
        tmarch.march(starts, compact, dirs_t, RenderConfig(), 128, block_sub=2)
    with pytest.raises(NotImplementedError):  # saved carries take no block list
        tmarch.march(starts, compact, dirs_t, RenderConfig(order="key"), 128, save_tin=True,
                     blocks=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError):  # the quad response trains in key order only
        tmarch.march(starts, compact, dirs_t, RenderConfig(order="window"), 128, save_tin=True,
                     origins_t=o, quad=True)
    with pytest.raises(ValueError):  # the per-ray-origin quad response needs origins
        tmarch.march(starts, compact, dirs_t, RenderConfig(), 128, quad=True)


# --- SH degrees 1-3 -----------------------------------------------------------

def _sh_feats(pair_feats: np.ndarray, degree: int) -> np.ndarray:
    """The JAX feature layout at SH `degree` from the SH 3 stream's rows:
    [mean, M, op, radius, sh_r[K], sh_g[K], sh_b[K], zero pad, quad block].
    The footprints and the pair stream do not depend on the SH degree."""
    K = (degree + 1) ** 2
    sh = [pair_feats[:, 14 + 16 * ch : 14 + 16 * ch + K] for ch in range(3)]
    head = np.concatenate([pair_feats[:, :14], *sh], axis=1)
    pad = np.zeros((pair_feats.shape[0], 64 - head.shape[1]), np.float32)
    return np.concatenate([head, pad, pair_feats[:, 64:]], axis=1)


@pytest.fixture(scope="module")
def sh_stream_inputs():
    """The 96x64 / 800-gaussian pair stream with all 16 SH coefficients."""
    scene = j_random_scene(800, seed=5)
    cam = JCamera.create(eye=(0.0, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=96, height=64)
    cfg = JConfig(hit_multiplicity=1, sh_degree=3)
    prepare = jax.jit(prepare_pair_stream, static_argnums=(2, 3, 4, 5))
    stream, pair_feats, _, _ = prepare(scene, cam, cfg, 65_536, 128, False)
    _, dirs, _ = generate_rays(cam, cfg)
    return dict(starts=np.array(stream.starts), eye=np.array(cam.eye),
                pair_feats=np.array(pair_feats), dirs_t=np.array(tile_rays(dirs, 16, 16)))


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("order,chunk,sh_mxu", [("window", 32, False), ("key", 128, False)])
def test_plain_sh_march_matches_pallas(sh_stream_inputs, degree, order, chunk, sh_mxu):
    """View-dependent colour per (ray, candidate): march_plain against
    pallas_march_stream(quad=True) with the JAX f32 colour loop (sh_mxu off)
    at the quad-path bar, >= 70 dB and max abs <= 1e-2; window order packs
    the per-(ray, candidate) colour through the 3x10-bit sorted payload."""
    inp = {**sh_stream_inputs, "pair_feats": _sh_feats(sh_stream_inputs["pair_feats"], degree)}
    kw = dict(hit_multiplicity=1, march_chunk=chunk, order=order, sh_degree=degree)
    want = _jax_march(inp, {**kw, "sh_mxu": sh_mxu}, chunk, packed16=False)
    starts, feats, dirs_t = _torch_args(inp)
    rows = tmarch.compact_features(feats, degree)
    assert rows.shape[1] == tmarch.quad_row(degree) == {1: 24, 2: 40, 3: 60}[degree]
    got = tmarch.march(starts, rows, dirs_t, RenderConfig(**kw), chunk)
    _assert_march_bars(got, want)
    assert float(got[1].min()) < 0.5
    sh0 = tmarch.march(starts, tmarch.compact_features(feats), dirs_t,
                       RenderConfig(**{**kw, "sh_degree": 0}), chunk)
    assert psnr(got[0].numpy(), sh0[0].numpy()) < 60.0  # the colour really depends on d


def test_plain_sh_march_matches_pallas_default_mxu(sh_stream_inputs):
    """SH 3 in window order against the TPU kernel's default `sh_mxu` path
    (bf16 hi/lo MXU splits, ~4e-6 relative of the f32 loop): the same bar."""
    inp = {**sh_stream_inputs, "pair_feats": _sh_feats(sh_stream_inputs["pair_feats"], 3)}
    kw = dict(hit_multiplicity=1, march_chunk=64, order="window", sh_degree=3)
    assert JConfig().sh_mxu
    want = _jax_march(inp, kw, 64, packed16=False)
    starts, feats, dirs_t = _torch_args(inp)
    got = tmarch.march(starts, tmarch.compact_features(feats, 3), dirs_t, RenderConfig(**kw), 64)
    _assert_march_bars(got, want)


def test_sh_rows_and_what_the_march_refuses(sh_stream_inputs):
    starts, feats, dirs_t = _torch_args(sh_stream_inputs)
    rows = tmarch.compact_features(feats, 3)
    assert torch.equal(rows[:, :12], tmarch.compact_features(feats)[:, :12])
    assert torch.equal(rows[:, 12:60], feats[:, 14:62])
    scalar = tmarch.scalar_features(feats, 3)
    assert scalar.shape[1] == tmarch.scalar_row(3) == 80
    assert torch.equal(scalar[:, tmarch.T_SH0:tmarch.T_SH0 + 48], feats[:, 14:62])
    assert torch.equal(tmarch.scalar_features(feats)[:, 16:], tmarch.train_features(feats)[:, 16:])
    sh3 = RenderConfig(sh_degree=3)
    with pytest.raises(ValueError):  # sh0 rows at SH 3
        tmarch.march(starts, tmarch.compact_features(feats), dirs_t, sh3, 128)
    with pytest.raises(ValueError):  # quad rows with per-ray origins
        tmarch.march(starts, rows, dirs_t, sh3, 128, origins_t=torch.zeros_like(dirs_t))
    # the SH 3 training rows: the scalar rows with the quad columns in 1..11
    train = tmarch.train_features(feats, 3)
    assert train.shape[1] == tmarch.train_row(3) == 80
    assert torch.equal(train[:, :12], rows[:, :12]) and torch.equal(train[:, 16:], scalar[:, 16:])
    # the key-order training march reads the coefficients from column T_SH0
    # of the training rows and composites what the render march does on the
    # quad rows at the training skip threshold
    key3 = sh3.replace(order="key")
    key = tmarch.march(starts, train, dirs_t, key3, 128, save_tin=True)
    render = tmarch.march(starts, rows, dirs_t,
                          key3.replace(chunk_skip_transmittance=key3.min_transmittance), 128)
    assert torch.equal(key[0], render[0]) and torch.equal(key[1], render[1])
    with pytest.raises(ValueError):  # saved carries take the training rows only
        tmarch.march(starts, rows, dirs_t, key3, 128, save_tin=True)
    with pytest.raises(NotImplementedError):  # window training: the scalar response
        tmarch.march(starts, train, dirs_t, sh3, 128, save_tin=True)


def test_fire_counter_on_a_crafted_two_tile_stream():
    """march_plain.fired counts the (tile, chunk) pairs whose window-sort
    fire test fires: two tiles see the same four gaussians along the view
    axis, tile 0 listed front to back (no inversion among the significant
    candidates), tile 1 back to front (inversions). march_bwd_plain counts
    the same on the training replay; key order never fires."""
    from gaussian_ray_tracing_tpu_torch.models.tiled import feature_table
    from gaussian_ray_tracing_tpu_torch.ops import march_bwd as tbwd
    from gaussian_ray_tracing_tpu_torch.scene.gaussians import GaussianScene

    n, R = 4, 32
    means = np.array([[0.0, 0.0, -1.0 - 0.5 * i] for i in range(n)], np.float32)
    scene = GaussianScene.from_activated(
        means, np.full((n, 3), 0.1, np.float32), np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
        np.full(n, 0.5, np.float32), np.zeros((n, 1, 3), np.float32))
    eye = torch.zeros(3)
    cfg = RenderConfig(hit_multiplicity=1, order="window", march_chunk=32)
    table, _, _ = feature_table(scene, cfg, eye=eye)
    order = torch.tensor([0, 1, 2, 3, 3, 2, 1, 0])
    starts = torch.tensor([0, n, 2 * n], dtype=torch.int32)
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.uniform(-0.01, 0.01, (2, R, 2)), -np.ones((2, R, 1))], -1)
    dirs_t = torch.tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32)

    feats = tmarch.compact_features(table)[order]
    tmarch.march_plain(starts, feats, dirs_t, cfg, 32)
    assert (tmarch.march_plain.chunks, tmarch.march_plain.fired) == (2, 1)
    assert tmarch.march_plain.significant == 2 * n * R  # every pair through the gate
    tmarch.march_plain(starts, feats, dirs_t, cfg.replace(order="key"), 32)
    assert (tmarch.march_plain.chunks, tmarch.march_plain.fired) == (2, 0)

    rows = tmarch.train_features(table)[order].contiguous()
    origins = eye.expand(dirs_t.shape).contiguous()
    _, _, tin, base = tmarch.march_plain(starts, rows, dirs_t, cfg, 32, save_tin=True,
                                         origins_t=origins)
    assert (tmarch.march_plain.chunks, tmarch.march_plain.fired) == (2, 1)
    g = torch.Generator().manual_seed(0)
    d_rgb = torch.randn(dirs_t.shape, generator=g)
    d_t = torch.randn(dirs_t.shape[:2], generator=g)
    tbwd.march_bwd_plain(starts, rows, dirs_t, eye, tin, base, d_rgb, d_t, cfg, 32)
    assert (tbwd.march_bwd_plain.chunks, tbwd.march_bwd_plain.fired) == (2, 1)
    assert tbwd.march_bwd_plain.significant == 2 * n * R
