"""One CUDA graph a pyramid level for the image ICP loop
(``align3d_torch/icp/level_graph.py``, routed by ``icp/image_icp.py``).

On the CPU (tier-1): the cache key differs by everything a captured launch
bakes in; CPU tensors never take the graph, the eager loop keeps its spans
and bits; the pieces the graph leans on (``_kernels.count``,
``profiling.paused``, ``icp_fused.own_arrivals``). The tests marked
``cuda`` skip without a card (the ``cuda_device`` fixture decides at run
time); on a GPU machine without JAX run ``python -m pytest --noconftest
tests/test_torch_gn_graph.py``: a graphed level bitwise the eager loop on
the card, for the exact engine and ``pallas_v4``, packed and unpacked, with
the eager loop's launch counts, and a new capture for new constants.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_torch import RangeImageBuilder, _kernels
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp import image_icp, level_graph
from align3d_torch.icp.multiscale import MultiscaleAlign
from align3d_torch.icp.params import IcpParams, MsIcpParams
from align3d_torch.image import RgbdFrame, RgbdImage
from align3d_torch.ops import icp_fused
from align3d_torch.ops.bilateral import BilateralFilter
from align3d_torch.se3 import Transform
from align3d_torch.utils import profiling

RGBD = Path(__file__).resolve().parent / "data" / "rgbd"
INTR = CameraIntrinsics(fx=40.0, fy=41.0, cx=31.5, cy=23.5, width=64, height=48)

# A changed value of each IcpParams field, of its own type.
CHANGED = {"max_iterations": 7, "weight": 0.5, "color_weight": 0.2, "max_point_to_plane_distance": 0.2,
           "max_distance": 0.25, "max_normal_angle": 0.5, "max_color_distance": 1.0, "huber_delta": 0.004,
           "engine": "pallas_v4", "band_radius": 2}


def _tensors(bsz: int = 1, h: int = 48, w: int = 64, device="cpu") -> tuple:
    """Level tensors of the shapes ``_BATCHED`` takes (their values unused)."""
    n = h * w
    f32 = torch.float32
    return (torch.zeros(bsz, 3, 3, device=device), torch.zeros(bsz, 3, device=device),
            torch.zeros(bsz, n, 3, device=device), torch.zeros(bsz, n, dtype=torch.bool, device=device),
            torch.zeros(bsz, n, dtype=torch.uint8, device=device), torch.zeros(bsz, n, 3, device=device),
            torch.zeros(bsz, n, dtype=torch.bool, device=device), torch.zeros(bsz, n, 3, device=device),
            torch.zeros(bsz, h + 2, w + 2, dtype=f32, device=device))


def _key(fn=image_icp._exact_eager, tensors=None, intrinsics=INTR, params=IcpParams()):
    return level_graph.key(fn, _tensors() if tensors is None else tensors, (intrinsics, params))


def test_key_is_equal_for_equal_inputs():
    assert _key() == _key(tensors=_tensors(), intrinsics=dataclasses.replace(INTR), params=IcpParams().replace())
    assert hash(_key()) == hash(_key(params=IcpParams()))


def test_changed_values_cover_every_params_field():
    assert set(CHANGED) == {f.name for f in dataclasses.fields(IcpParams)}


@pytest.mark.parametrize("field", sorted(CHANGED))
def test_key_differs_by_every_params_field(field):
    changed = IcpParams().replace(**{field: CHANGED[field]})
    assert getattr(changed, field) != getattr(IcpParams(), field)
    assert _key(params=changed) != _key()


@pytest.mark.parametrize("field", ["fx", "fy", "cx", "cy"])
def test_key_differs_by_intrinsics(field):
    assert _key(intrinsics=dataclasses.replace(INTR, **{field: getattr(INTR, field) + 0.5})) != _key()


@pytest.mark.parametrize("shape", [(2, 48, 64), (1, 24, 32), (1, 48, 66)])
def test_key_differs_by_shape(shape):
    assert _key(tensors=_tensors(*shape)) != _key()


def test_key_differs_by_dtype_and_engine():
    tensors = list(_tensors())
    tensors[3] = tensors[3].to(torch.uint8)
    assert _key(tensors=tuple(tensors)) != _key()
    keys = {_key(fn=fn) for fn in image_icp._EAGER.values()}
    keys |= {_key(fn=fn) for fn in (image_icp._exact_loop, image_icp._v3_loop, image_icp._v4_loop)}
    assert len(keys) == 6


def _frames(n: int = 3, h: int = 48, w: int = 64, device="cpu"):
    """A textured relief drifting one pixel a frame, as 2-level pyramids."""
    rng = np.random.default_rng(0)
    tex = rng.uniform(50, 200, size=(h + 16, w + n + 16, 3)).astype(np.uint8)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    builder = RangeImageBuilder(bilateral_filter=BilateralFilter(), pyramid_levels=2)
    out = []
    for i in range(n):
        depth = (2000 + 3 * (xs + i) + 2 * ys + 40 * np.sin((xs + i) * 0.35) * np.cos(ys * 0.3)).astype(np.uint16)
        out.append(builder.build(RgbdFrame(INTR, RgbdImage(tex[4:4 + h, 4 + i:4 + i + w], depth, 0.001)), device))
    return out


def _flat(target, source, bsz: int = 1) -> tuple:
    """(B, ...) level tensors of one pair repeated B times, as ``_BATCHED`` takes them."""
    n = target.height * target.width

    def rep(t, *shape):
        return t.reshape(1, *shape).expand(bsz, *shape).contiguous()

    return (rep(source.points, n, 3), rep(source.mask, n), rep(source.intensities, n), rep(target.points, n, 3),
            rep(target.mask, n), rep(target.normals, n, 3), rep(target.intensity_map, *target.intensity_map.shape))


@pytest.mark.parametrize("engine", ["xla", "pallas_v4"])
def test_cpu_takes_the_eager_loop_with_its_spans(engine):
    """On CPU tensors: no capture, no replay, no launch; the eager loop's
    spans under each level, and the same bits through ``_BATCHED`` and
    ``_EAGER``."""
    pyr = _frames(2)
    base = MsIcpParams.default() if engine == "xla" else MsIcpParams.default_tpu(engine)
    params = MsIcpParams(tuple(p.replace(max_iterations=3) for p in base[:2]))
    counts, launches = level_graph.counts(), _kernels.launches()
    profiling.clear()
    with profiling.recording():
        pose = MultiscaleAlign(params, pyr[0]).align(pyr[1])
    spans = list(profiling.spans())
    profiling.clear()
    names = [s.name for s in spans]
    assert names.count("gn.iter") == names.count("gn.step") == names.count("gn.solve") == 6
    assert "gn.replay" not in names
    assert all(spans[s.parent].name == "icp.level" for s in spans if s.name == "gn.iter")
    assert level_graph.counts() == counts and _kernels.launches() == launches
    assert bool(torch.isfinite(pose.rotation).all())

    ident = Transform.identity((2,))
    args = (ident.rotation, ident.translation, *_flat(pyr[0][0], pyr[1][0], 2), INTR, params[0])
    got = image_icp._BATCHED[engine](*args)
    want = image_icp._EAGER[engine](*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cpu_packed_aligns_are_the_eager_loops():
    pyr = _frames(2)
    flat = _flat(pyr[0][0], pyr[1][0], 2)
    ident = Transform.identity((2,))
    exact = IcpParams(max_iterations=3)
    packed = image_icp.prepack_batched(*flat)
    got = image_icp.align_impl_batched(ident.rotation, ident.translation, packed, INTR, exact)
    want = image_icp._exact_loop(ident.rotation, ident.translation, *packed, INTR, exact)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    banded = IcpParams(max_iterations=3, engine="pallas_v4")
    sp, tp, centroids, h, w = image_icp.prepack_v4_batched(*flat, INTR)
    got = image_icp.align_impl_pallas_v4_batched_packed(ident.rotation, ident.translation, sp, tp, centroids, INTR,
                                                        h, w, banded)
    want = image_icp._v4_loop(ident.rotation, ident.translation, sp, tp, *centroids, h, w, INTR, banded)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_count_adds_and_takes_back():
    before = _kernels.launches()
    _kernels.count("K1", 70)
    _kernels.count("K11", 3)
    assert {k: n for k, n in _kernels.launches(before).items() if n} == {"K1": 70, "K11": 3}
    _kernels.count("K1", -70)
    _kernels.count("K11", -3)
    assert _kernels.launches() == before


def test_paused_records_no_span():
    profiling.clear()
    with profiling.recording():
        with profiling.span("outer"):
            with profiling.paused():
                with profiling.span("hidden"):
                    profiling.end(profiling.begin("hidden.child"))
                with profiling.paused():
                    profiling.end(profiling.begin("hidden.nested"))
                profiling.end(profiling.begin("hidden.after"))
            profiling.end(profiling.begin("inner"))
    spans = list(profiling.spans())
    profiling.clear()
    assert [s.name for s in spans] == ["outer", "inner"]
    assert spans[1].parent == 0 and spans[0].end is not None


def test_own_arrivals_installs_and_restores():
    dev, stream = torch.device("cpu"), 12345
    mine, kept = torch.zeros(64, dtype=torch.int32), torch.zeros(64, dtype=torch.int32)
    with icp_fused.own_arrivals(dev, stream, mine):
        assert icp_fused._arrivals(dev, stream, 4) is mine
    assert (dev, stream) not in icp_fused._ARRIVALS
    icp_fused._ARRIVALS[(dev, stream)] = kept
    try:
        with icp_fused.own_arrivals(dev, stream, mine):
            assert icp_fused._arrivals(dev, stream, 64) is mine
        assert icp_fused._arrivals(dev, stream, 64) is kept
    finally:
        del icp_fused._ARRIVALS[(dev, stream)]


# -- on the card ------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sample1(cuda_device):
    """3-level pyramids of sample1's first six frames, built on the card."""
    from align3d_torch.io.datasets import SlamTbDataset

    ds = SlamTbDataset.load(str(RGBD / "sample1"))
    builder = RangeImageBuilder(bilateral_filter=BilateralFilter(), pyramid_levels=3)
    return [builder.build(ds.get(i), cuda_device) for i in range(6)]


@pytest.fixture
def fresh():
    """An empty graph cache (restored after), so a test sees its own captures."""
    kept = {dev: levels.copy() for dev, levels in level_graph._cache.items()}
    level_graph._cache.clear()
    yield
    level_graph._cache.clear()
    level_graph._cache.update(kept)


def _pairs(pyr, level: int, pairs: list) -> tuple:
    """(B, ...) level tensors of the (target, source) frame pairs."""
    tgt = [pyr[t][level] for t, _ in pairs]
    src = [pyr[s][level] for _, s in pairs]
    b, n = len(pairs), tgt[0].height * tgt[0].width

    def cat(images, field, *shape):
        return torch.stack([getattr(ri, field).reshape(*shape) for ri in images])

    return (cat(src, "points", n, 3), cat(src, "mask", n), cat(src, "intensities", n), cat(tgt, "points", n, 3),
            cat(tgt, "mask", n), cat(tgt, "normals", n, 3), cat(tgt, "intensity_map", *tgt[0].intensity_map.shape))


def _start(device, bsz: int):
    pose = Transform.exp(torch.tensor([0.01, -0.005, 0.003, 0.002, -0.004, 0.001], device=device))
    return pose.rotation.expand(bsz, 3, 3), pose.translation.expand(bsz, 3)


def _per_iteration(engine: str, iterations: int) -> dict:
    if engine == "xla":
        return {"K1": iterations, "K11": iterations}
    return {"K9": 1, "K10": iterations, "K8": iterations, "K11": iterations}


def _nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def _same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _call(fn, *args):
    """``fn(*args)``, its launches and the captures and replays it made."""
    counts, launches = level_graph.counts(), _kernels.launches()
    out = fn(*args)
    torch.cuda.synchronize()
    now = level_graph.counts()
    return out, _nonzero(_kernels.launches(launches)), {k: now[k] - counts[k] for k in now}


CASES = [("xla", 1, 0), ("xla", 1, 1), ("xla", 1, 2), ("pallas_v4", 4, 0), ("pallas_v4", 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("engine,bsz,level", CASES)
def test_graphed_level_is_bitwise_the_eager_loop(sample1, cuda_device, fresh, engine, bsz, level):
    """The first call runs the eager loop (its launches, one capture that
    counts none); later calls replay, each with the eager loop's launches
    and bits. Two calls on other frames in a row each match the eager loop,
    and the first call's result is not written over by the second's replay."""
    base = MsIcpParams.default() if engine == "xla" else MsIcpParams.default_tpu(engine)
    params, intr = base[level], sample1[0][level].intrinsics
    rot, trans = _start(cuda_device, bsz)
    graphed, eager = image_icp._BATCHED[engine], image_icp._EAGER[engine]
    pairs = [[(k, k + 1) for k in range(bsz)], [(k + 1, k) for k in range(bsz)], [(k + 2, k) for k in range(bsz)]]
    want_launches = _per_iteration(engine, params.max_iterations)
    results, wants = [], []
    for i, chosen in enumerate(pairs):
        args = (rot, trans, *_pairs(sample1, level, chosen), intr, params)
        want, eager_launches, eager_counts = _call(eager, *args)
        got, launches, counts = _call(graphed, *args)
        assert eager_launches == want_launches and eager_counts == {"captures": 0, "replays": 0}
        assert launches == want_launches
        assert counts == ({"captures": 1, "replays": 0} if i == 0 else {"captures": 0, "replays": 1})
        assert _same(got, want), i
        results.append(got)
        wants.append(want)
    assert all(_same(r, w) for r, w in zip(results, wants))  # nothing earlier written over
    assert not _same(results[1], results[2])
    assert [tuple(t.shape) for t in results[2]] == [(bsz, 3, 3), (bsz, 3), (bsz,)]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["xla", "pallas_v4"])
def test_graphed_packed_level_is_bitwise_the_eager_loop(sample1, cuda_device, fresh, engine):
    """The packed entry points (the benches'): a replay bitwise the eager
    loop on other packs, with no prepack launch in it."""
    params = (MsIcpParams.default() if engine == "xla" else MsIcpParams.default_tpu(engine))[1]
    intr = sample1[0][1].intrinsics
    rot, trans = _start(cuda_device, 2)
    for i, chosen in enumerate(([(0, 1), (1, 2)], [(2, 1), (3, 2)])):
        flat = _pairs(sample1, 1, chosen)
        if engine == "xla":
            packed = image_icp.prepack_batched(*flat)
            want = image_icp._exact_loop(rot, trans, *packed, intr, params)
            got, launches, counts = _call(image_icp.align_impl_batched, rot, trans, packed, intr, params)
        else:
            sp, tp, centroids, h, w = image_icp.prepack_v4_batched(*flat, intr)
            want = image_icp._v4_loop(rot, trans, sp, tp, *centroids, h, w, intr, params)
            got, launches, counts = _call(image_icp.align_impl_pallas_v4_batched_packed, rot, trans, sp, tp,
                                          centroids, intr, h, w, params)
        wanted = _per_iteration(engine, params.max_iterations)
        wanted.pop("K9", None)
        assert launches == wanted and counts["replays"] == i and counts["captures"] == 1 - i
        assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["max_distance", "intrinsics"])
def test_new_constants_capture_anew(sample1, cuda_device, fresh, change):
    """Another ``max_distance`` or other intrinsics make a capture of their
    own, and the replay of the first is not reused for them."""
    level, params = 1, MsIcpParams.default()[1]
    intr = sample1[0][level].intrinsics
    rot, trans = _start(cuda_device, 1)
    flat = _pairs(sample1, level, [(0, 1)])
    other_params, other_intr = params, intr
    if change == "max_distance":
        other_params = params.replace(max_distance=0.02)
    else:
        other_intr = dataclasses.replace(intr, fx=intr.fx * 1.02, cx=intr.cx + 0.5)
    for p, k in ((params, intr), (params, intr), (other_params, other_intr), (other_params, other_intr)):
        _call(image_icp._BATCHED["xla"], rot, trans, *flat, k, p)
    assert len(level_graph._cache[rot.device]) == 2
    got, _, counts = _call(image_icp._BATCHED["xla"], rot, trans, *flat, other_intr, other_params)
    want = image_icp._EAGER["xla"](rot, trans, *flat, other_intr, other_params)
    first = image_icp._EAGER["xla"](rot, trans, *flat, intr, params)
    assert counts == {"captures": 0, "replays": 1}
    assert _same(got, want) and not _same(got, first)


@pytest.mark.cuda
def test_replays_keep_their_own_arrival_counters(sample1, cuda_device, fresh):
    """Eager launches of K1 on the same stream and replays on a side stream
    between replays change no bit; a graph's counters are no stream's."""
    params, intr = MsIcpParams.default()[2], sample1[0][2].intrinsics
    rot, trans = _start(cuda_device, 1)
    flat = _pairs(sample1, 2, [(0, 1)])
    args = (rot, trans, *flat, intr, params)
    want = image_icp._EAGER["xla"](*args)
    image_icp._BATCHED["xla"](*args)  # the capture
    (level,) = level_graph._cache[rot.device].values()
    assert all(level.arrivals is not c for c in icp_fused._ARRIVALS.values())
    side = torch.cuda.Stream(cuda_device)
    for k in range(3):
        if k == 1:
            side.wait_stream(torch.cuda.current_stream(cuda_device))
            with torch.cuda.stream(side):
                got = image_icp._BATCHED["xla"](*args)
            torch.cuda.current_stream(cuda_device).wait_stream(side)
        else:
            got = image_icp._BATCHED["xla"](*args)
        image_icp._EAGER["xla"](*args)
        torch.cuda.synchronize()
        assert _same(got, want), k


@pytest.mark.cuda
def test_tracker_levels_record_one_replay_span_each(sample1, cuda_device, fresh):
    """A multiscale align on the card: after the first (eager, capturing)
    align, one ``gn.replay`` span under each ``icp.level`` and no
    ``gn.iter``; the poses bitwise the first align's on the same frames."""
    params = MsIcpParams.default()
    first = MultiscaleAlign(params, sample1[0]).align(sample1[1])
    profiling.clear()
    with profiling.recording():
        again = MultiscaleAlign(params, sample1[0]).align(sample1[1])
    spans = list(profiling.spans())
    profiling.clear()
    replays = [s for s in spans if s.name == "gn.replay"]
    assert len(replays) == 3 and all(spans[s.parent].name == "icp.level" for s in replays)
    assert not [s for s in spans if s.name in ("gn.iter", "gn.step", "gn.solve")]
    assert torch.equal(first.rotation, again.rotation) and torch.equal(first.translation, again.translation)
