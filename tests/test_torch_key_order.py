"""Key order's sure-miss path and its plain march.

1. csrc/march.cuh stops a candidate before the division and the exp when
   `sure_miss` (against the row's `miss_threshold`) proves that its alpha
   is at most alpha_min, in `eval_quad` (the shared-origin quad response,
   with key order's sqrt-free fast gate on full-range rays or the exact
   event gate) and in `eval_scalar` (per-ray origins, where dd >= 1e-6).
   Here a float32 numpy model of those functions, operation by operation
   in the kernel's order (-fmad=false: every product and sum rounded;
   fmaxf/fminf as np.fmax/np.fmin, which drop a NaN operand), shows that
   the short cut never drops a candidate whose full evaluation has alpha >
   alpha_min: on the rows and rays of real pair streams, on candidates
   built within 1e-4 of the threshold (with |oo| up to 1e4, where pp = oo -
   od^2/dd cancels), with dd at and below 1e-6, and on NaN rows.
2. The plain key-order march against the JAX Pallas march (interpret
   mode) on crafted streams: every candidate a sure miss, every other one,
   chunks skipped after the stream turns opaque, and tiles shorter than the
   chunk; at the JAX suite's bars (PSNR >= 70 dB, max abs <= 1e-2).
"""

import jax
import numpy as np
import pytest
import torch

from gaussian_ray_tracing_tpu.cameras import Camera as JCamera
from gaussian_ray_tracing_tpu.cameras import generate_rays as j_generate_rays
from gaussian_ray_tracing_tpu.config import RenderConfig as JConfig
from gaussian_ray_tracing_tpu.models.pallas_renderer import prepare_pair_stream as j_prepare
from gaussian_ray_tracing_tpu.models.tiled import tile_rays as j_tile_rays
from gaussian_ray_tracing_tpu.ops.pallas_march import pallas_march_stream
from gaussian_ray_tracing_tpu.scene.synthetic import random_scene as j_random_scene
from gaussian_ray_tracing_tpu_torch import cameras
from gaussian_ray_tracing_tpu_torch.config import RenderConfig
from gaussian_ray_tracing_tpu_torch.models.gpu_renderer import prepare_pair_stream
from gaussian_ray_tracing_tpu_torch.models.rolling import prepare_rolling_stream
from gaussian_ray_tracing_tpu_torch.models.tiled import tile_rays
from gaussian_ray_tracing_tpu_torch.ops import march as tmarch
from gaussian_ray_tracing_tpu_torch.scene.synthetic import random_scene
from gaussian_ray_tracing_tpu_torch.utils.image import psnr

torch.set_num_threads(1)
F32 = np.float32
ALPHA_MIN, ALPHA_CLAMP = F32(0.01), F32(0.99)
EYE = (0.0, 0.2, 2.6)


# --- the float32 model of csrc/march.cuh ----------------------------------

def miss_threshold(op):
    return F32(2.0) * np.log(op / ALPHA_MIN) + F32(1e-4)


def sure_miss(oo, od, D, thr):
    return oo * D - od * od > (thr + F32(2e-6) * np.abs(oo)) * D


def eval_quad(f, d, t_lo, t_hi, fast_gate):
    """f (N, 16) compact rows, d (N, 3) directions -> (short cut taken,
    alpha, a) of eval_quad<true> (live rays, hit multiplicity 1)."""
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    m = (dx * dx, dy * dy, dz * dz, F32(2.0) * dx * dy, F32(2.0) * dx * dz, F32(2.0) * dy * dz)
    dd = f[:, 1] * m[0] + f[:, 2] * m[1] + f[:, 3] * m[2] + f[:, 4] * m[3] + f[:, 5] * m[4] \
        + f[:, 6] * m[5]
    od = f[:, 7] * dx + f[:, 8] * dy + f[:, 9] * dz
    cq, oo = f[:, 10], f[:, 11]
    D = np.fmax(dd, F32(1e-6))
    short = sure_miss(oo, od, D, miss_threshold(f[:, 0]))
    t_star = -od * (F32(1.0) / D)
    pp = oo + od * t_star
    alpha = np.fmin(ALPHA_CLAMP, np.exp(F32(-0.5) * np.fmax(pp, F32(0.0))) * f[:, 0])
    if fast_gate:
        q_lo = cq + t_lo * (F32(2.0) * od + t_lo * dd)
        gate = (t_star >= t_lo) | (q_lo < F32(0.0))
    else:
        disc = od * od - dd * cq
        sq = np.sqrt(np.fmax(disc, F32(0.0)))
        inv_dd = F32(1.0) / np.fmax(dd, F32(1e-12))
        t_entry, t_exit = (-od - sq) * inv_dd, (-od + sq) * inv_dd
        t_ev = np.where(t_entry < t_lo, t_exit, t_entry)
        gate = (t_ev >= t_lo) & (t_ev <= t_hi)
    a = np.where((alpha > ALPHA_MIN) & gate, alpha, F32(0.0))
    return short, alpha, a


def eval_scalar(f, o, d, t_lo, t_hi):
    """f (N, >= 29) scalar rows, o, d (N, 3) per-ray origins and directions
    -> (short cut taken, alpha, a) of eval_scalar<true>."""
    mean, m, rad = f[:, tmarch.T_MX:tmarch.T_MX + 3], f[:, tmarch.T_M0:tmarch.T_M0 + 9], \
        f[:, tmarch.T_RAD]
    ox, oy, oz = (o[:, k] - mean[:, k] for k in range(3))
    og = [m[:, 3 * i] * ox + m[:, 3 * i + 1] * oy + m[:, 3 * i + 2] * oz for i in range(3)]
    dg = [m[:, 3 * i] * d[:, 0] + m[:, 3 * i + 1] * d[:, 1] + m[:, 3 * i + 2] * d[:, 2]
          for i in range(3)]
    dd = dg[0] * dg[0] + dg[1] * dg[1] + dg[2] * dg[2]
    od = og[0] * dg[0] + og[1] * dg[1] + og[2] * dg[2]
    oo = og[0] * og[0] + og[1] * og[1] + og[2] * og[2]
    D = np.fmax(dd, F32(1e-6))
    short = (dd >= F32(1e-6)) & sure_miss(oo, od, D, miss_threshold(f[:, 0]))
    t_star = -od / D
    pp = oo + t_star * (F32(2.0) * od + t_star * dd)
    alpha = np.fmin(ALPHA_CLAMP, np.exp(F32(-0.5) * np.fmax(pp, F32(0.0))) * f[:, 0])
    cq = oo - rad * rad
    disc = od * od - dd * cq
    sq = np.sqrt(np.fmax(disc, F32(0.0)))
    inv_dd = F32(1.0) / np.fmax(dd, F32(1e-12))
    t_entry, t_exit = (-od - sq) * inv_dd, (-od + sq) * inv_dd
    t_ev = np.where(t_entry < t_lo, t_exit, t_entry)
    gate = (disc >= F32(0.0)) & (t_ev >= t_lo) & (t_ev <= t_hi)
    a = np.where((alpha > ALPHA_MIN) & gate, alpha, F32(0.0))
    return short, alpha, a


# --- candidates --------------------------------------------------------------

def _pairs(starts, rows, dirs_t, *extra):
    """Every (ray, candidate) pair of every tile: rows, then the per-ray
    arrays, each (pairs, ...)."""
    starts = starts.numpy()
    counts = np.diff(starts)
    tile = np.repeat(np.arange(len(counts)), counts)
    R = dirs_t.shape[1]
    row_idx = np.repeat(np.arange(starts[-1]), R)
    ray_idx = np.tile(np.arange(R), starts[-1])
    out = [rows.numpy()[row_idx]]
    for x in (dirs_t, *extra):
        out.append(x.numpy()[np.repeat(tile, R), ray_idx])
    return out


def _near_threshold(n, seed, dd=None):
    """n synthetic quad candidates along d = (1, 0, 0) (so dd and od are
    exact): opacity op, pp = oo - od^2/D within 1e-4 of L = 2 ln(op /
    alpha_min) or of the threshold L + 1e-4, |oo| up to 1e4 (cancelling),
    and dd given or log-uniform in [1e-6, 1e3]. Returns (rows, dirs)."""
    rng = np.random.default_rng(seed)
    op = rng.uniform(0.0101, 0.99, n)
    L = 2.0 * np.log(op / 0.01)
    pp = L + rng.uniform(-1e-4, 2e-4, n)
    dd = 10.0 ** rng.uniform(-6, 3, n) if dd is None else np.full(n, dd)
    oo = np.maximum(10.0 ** rng.uniform(-3, 4, n), pp)
    od = np.sqrt((oo - pp) * np.maximum(dd, 1e-6)) * rng.choice([-1.0, 1.0], n)
    f = np.zeros((n, tmarch.ROW))
    f[:, 0], f[:, 1], f[:, 7], f[:, 11] = op, dd, od, oo
    f[:, 10] = oo - L  # cq = oo - radius^2
    d = np.zeros((n, 3))
    d[:, 0] = 1.0
    return f.astype(F32), d.astype(F32)


@pytest.fixture(scope="module")
def quad_stream():
    scene = random_scene(800, seed=5)
    cam = cameras.Camera.create(eye=EYE, lookat=(0.0, 0.0, 0.0), width=96, height=64)
    cfg = RenderConfig(hit_multiplicity=1, order="key", march_chunk=128)
    stream, feats, _ = prepare_pair_stream(scene, cam, cfg, 1 << 16)
    dirs_t = tile_rays(cameras.generate_rays(cam, cfg)[1], 16, 16)
    return _pairs(stream.starts, feats, dirs_t)


def _assert_conservative(short, alpha, a, min_share):
    dropped = short & (alpha > ALPHA_MIN)
    assert not dropped.any(), f"{int(dropped.sum())} candidates above alpha_min were cut short"
    assert not (short & (a > 0)).any()
    assert short.mean() >= min_share  # the short cut is taken


@pytest.mark.parametrize("fast_gate", [True, False])
@pytest.mark.parametrize("source", ["stream", "threshold", "small_dd", "nan"])
def test_quad_sure_miss_never_drops_a_hit(quad_stream, source, fast_gate):
    """eval_quad: the short cut implies alpha <= alpha_min, with key
    order's fast gate and with the exact event gate."""
    t_lo, t_hi = F32(0.0), F32(1e30)
    if source == "stream":
        f, d = quad_stream
        min_share = 0.3
    elif source == "threshold":
        f, d = _near_threshold(400_000, seed=1)
        min_share = 0.1
    elif source == "small_dd":
        parts = [_near_threshold(50_000, seed=2 + i, dd=v) for i, v in enumerate(
            (1e-6, np.nextafter(F32(1e-6), F32(0)), 5e-7, 1e-9, 0.0))]
        f, d = (np.concatenate(x) for x in zip(*parts))
        min_share = 0.1
    else:  # a NaN in one column of each row
        f, d = _near_threshold(60_000, seed=7)
        cols = np.array([0, 1, 7, 10, 11])
        f[np.arange(len(f)), cols[np.arange(len(f)) % len(cols)]] = np.nan
        min_share = 0.0
    with np.errstate(all="ignore"):
        short, alpha, a = eval_quad(f, d, t_lo, t_hi, fast_gate)
    _assert_conservative(short, alpha, a, min_share)
    if source == "nan":  # a NaN opacity, oo or od fails the test
        for col in (0, 7, 11):
            assert not short[np.isnan(f[:, col])].any()
    if source == "threshold":  # the rows on either side of alpha_min
        assert (alpha > ALPHA_MIN).mean() > 0.2 and (alpha <= ALPHA_MIN).mean() > 0.2


def _scalar_near_threshold(n, seed, k=None):
    """n synthetic scalar candidates: M = k I (dd = k^2 along d = (1, 0,
    0)), mean 0, origin (x, y, 0) with pp = k^2 y^2 within 1e-4 of L or of
    the threshold and |x| up to 100 (od^2 / dd cancelling oo)."""
    rng = np.random.default_rng(seed)
    op = rng.uniform(0.0101, 0.99, n)
    L = 2.0 * np.log(op / 0.01)
    pp = L + rng.uniform(-1e-4, 2e-4, n)
    k = 10.0 ** rng.uniform(-3, 1.5, n) if k is None else np.full(n, k)
    f = np.zeros((n, tmarch.scalar_row(0)))
    f[:, 0] = op
    for i in range(3):
        f[:, tmarch.T_M0 + 4 * i] = k
    f[:, tmarch.T_RAD] = np.sqrt(L)
    o = np.zeros((n, 3))
    o[:, 0] = rng.uniform(-100, 100, n) * rng.choice([0.0, 1.0], n, p=[0.2, 0.8])
    o[:, 1] = np.sqrt(pp) / k
    d = np.zeros((n, 3))
    d[:, 0] = 1.0
    return f.astype(F32), o.astype(F32), d.astype(F32)


@pytest.mark.parametrize("source", ["stream", "threshold", "small_dd", "nan"])
def test_scalar_sure_miss_never_drops_a_hit(source):
    """eval_scalar (per-ray origins): the short cut, taken only where dd >=
    1e-6, implies alpha <= alpha_min."""
    t_lo, t_hi = F32(0.0), F32(1e30)
    if source == "stream":
        scene = random_scene(600, seed=3)
        cam0 = cameras.Camera.create(eye=EYE, lookat=(0.0, 0.0, 0.0), width=64, height=48)
        cam1 = cameras.Camera.create(eye=(0.05, 0.2, 2.6), lookat=(0.0, 0.0, 0.0), width=64,
                                     height=48)
        cfg = RenderConfig(hit_multiplicity=1, order="key", march_chunk=128)
        starts, rows, dirs_t, origins_t, _, _ = prepare_rolling_stream(scene, cam0, cam1, cfg)
        f, d, o = _pairs(starts, rows, dirs_t, origins_t)
        min_share = 0.3
    elif source == "threshold":
        f, o, d = _scalar_near_threshold(400_000, seed=11)
        min_share = 0.1
    elif source == "small_dd":  # dd = k^2 around 1e-6 and below
        parts = [_scalar_near_threshold(40_000, seed=12 + i, k=v) for i, v in enumerate(
            (1e-3, np.nextafter(F32(1e-3), F32(0)), np.nextafter(F32(1e-3), F32(1)), 5e-4,
             1e-5))]
        f, o, d = (np.concatenate(x) for x in zip(*parts))
        min_share = 0.0
    else:
        f, o, d = _scalar_near_threshold(60_000, seed=17)
        cols = np.array([0, tmarch.T_MX, tmarch.T_M0, tmarch.T_M0 + 4, tmarch.T_RAD])
        f[np.arange(len(f)), cols[np.arange(len(f)) % len(cols)]] = np.nan
        o[::7, 1] = np.nan
        min_share = 0.0
    with np.errstate(all="ignore"):
        short, alpha, a = eval_scalar(f, o, d, t_lo, t_hi)
    _assert_conservative(short, alpha, a, min_share)
    if source == "small_dd":  # no short cut below dd = 1e-6
        k = f[:, tmarch.T_M0]
        assert not short[k * k < F32(1e-6)].any()
        assert short[k * k >= F32(1e-6)].mean() > 0.2
    if source == "nan":
        assert not short[np.isnan(f[:, 0]) | np.isnan(o[:, 1])].any()


# --- the plain key-order march on crafted streams ---------------------------

@pytest.fixture(scope="module")
def jax_stream():
    """One JAX pair stream (96x64, 800 gaussians) as numpy arrays."""
    scene = j_random_scene(800, seed=5)
    cam = JCamera.create(eye=EYE, lookat=(0.0, 0.0, 0.0), width=96, height=64)
    cfg = JConfig(hit_multiplicity=1)
    prepare = jax.jit(j_prepare, static_argnums=(2, 3, 4, 5))
    stream, pair_feats, _, _ = prepare(scene, cam, cfg, 65_536, 128, False)
    _, dirs, _ = j_generate_rays(cam, cfg)
    return (np.array(stream.starts), np.array(cam.eye), np.array(pair_feats),
            np.array(j_tile_rays(dirs, 16, 16)))


def _crafted(inp, kind, chunk):
    """(starts, pair_feats) of the stream, made into `kind`."""
    starts, _, feats, _ = inp
    feats = feats.copy()
    if kind == "all_sure_miss":  # opacity below alpha_min: L < 0, every pp >= 0 misses
        feats[:, 12] = 0.005
    elif kind == "every_other_sure_miss":
        feats[::2, 12] = 0.005
    elif kind == "skipped":  # nearly opaque: T falls below the skip threshold early
        feats[:, 12] = np.maximum(feats[:, 12], 0.95)
    else:  # shorter than the chunk: each tile keeps its first n < chunk candidates
        rng = np.random.default_rng(chunk)
        counts = np.minimum(np.diff(starts), rng.integers(0, chunk, len(starts) - 1))
        counts[::5] = 0  # and some tiles none
        keep = np.concatenate([np.arange(s, s + n) for s, n in zip(starts[:-1], counts)])
        # the stream's capacity stays (the Pallas kernel copies whole chunks)
        feats = np.concatenate([feats[keep], np.zeros((len(feats) - len(keep), feats.shape[1]),
                                                      feats.dtype)])
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return starts, feats


@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("kind", ["all_sure_miss", "every_other_sure_miss", "skipped",
                                  "shorter_than_chunk"])
def test_plain_key_march_on_crafted_streams_matches_pallas(jax_stream, kind, chunk):
    starts, feats = _crafted(jax_stream, kind, chunk)
    eye, dirs_t = jax_stream[1], jax_stream[3]
    kw = dict(hit_multiplicity=1, march_chunk=chunk, chunk_skip_transmittance=0.02,
              order="key")
    T, R = dirs_t.shape[:2]
    want = pallas_march_stream(starts, eye, feats, dirs_t, JConfig(**kw), n_tiles=T,
                               rays_per_tile=R, chunk=chunk, interpret=True, quad=True,
                               packed16=False)
    got = tmarch.march_stream(torch.from_numpy(starts), torch.from_numpy(feats),
                              torch.from_numpy(dirs_t), RenderConfig(**kw), chunk)
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        assert psnr(a, b) >= 70.0 and np.abs(a - b).max() <= 1e-2
    rgb, t_final = (x.numpy() for x in got)
    counts = np.diff(starts)
    chunks = int(np.sum(-(-counts // chunk)))
    if kind == "all_sure_miss":
        assert not rgb.any() and (t_final == 1.0).all()
    elif kind == "skipped":  # chunks were skipped, and the frame is opaque
        assert tmarch.march_plain.chunks < chunks and float(t_final.min()) < 0.02
    elif kind == "shorter_than_chunk":
        assert counts.max() < chunk and (counts == 0).any()
    else:
        assert float(t_final.min()) < 0.9
