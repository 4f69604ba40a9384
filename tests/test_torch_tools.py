"""The port's profiling scripts and its quality gate: their interval and
grouping arithmetic, their refusal to run without a CUDA device, and their
--precision flag."""
import numpy as np
import pytest
import torch

from zest_tpu_torch.kernels import trilinear
from zest_tpu_torch.kernels import fused_mlp
from zest_tpu_torch.models.nerf import NeRFField
from zest_tpu_torch.tools import (probe_bf16_sums, probe_device_ms,
                                  probe_trilinear, probe_wgrad, profile_eval,
                                  profile_train, quality_gate)


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 12), (20, 25)], 17.0),       # overlap, then a gap
    ([(20, 25), (0, 10), (2, 3)], 15.0),        # unsorted, nested
])
def test_busy_union(intervals, busy):
    assert profile_eval.busy_union_us(intervals) == busy


@pytest.mark.parametrize("name,group", [
    ("void fused_nerf_kernel<256>(float const*)", "K6 fused field"),
    ("trilinear_sample_kernel", "K3 volume lookup"),
    ("(anonymous namespace)::trilinear_sample_kernel(float4 const*, float "
     "const*, float4*, int, int, long long, int, int, int)",
     "K3 volume lookup"),
    ("color_gather_kernel", "K8 color gather"),
    ("plane_sweep_warp_kernel", "K1 warp"),
    ("sm90_xmma_fprop_implicit_gemm_cudnn", "cuDNN conv / deconv + batch norm"),
    ("sm90_xmma_dgrad_implicit_gemm_f32f32", "cuDNN conv / deconv + batch norm"),
    ("ampere_sgemm_128x64_nn", "cuBLAS gemm"),
    ("void at::native::CatArrayBatchedCopy<float>", "torch.cat copies"),
    ("void at::native::scatter_gather_elementwise_kernel",
     profile_eval.OTHER),
    ("(anonymous namespace)::round_pack_tc_kernel(float const*, TcParams)",
     "K6 bf16 weight pack"),
    ("(anonymous namespace)::pack_tc32_kernel(float const*, "
     "TcParamsOf<float>)", "K6 float32 weight pack"),
])
def test_kernel_groups(name, group):
    assert profile_eval.group_of(name) == group


def test_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_eval.main() == 2


@pytest.mark.parametrize("name,group", [
    ("void row_gather_kernel(uint4 const*, int const*)", "K9 row gather"),
    ("void row_scatter_add_kernel<__nv_bfloat16>(uint4 const*)",
     "K9 row gather backward (scatter-add)"),
    ("round_pack_kernel(float*, RParts)", "K6 / K7 bf16 weight rounding"),
    ("(anonymous namespace)::round_pack_tc_kernel(float const*, TcParams)",
     "K6 / K7 bf16 weight rounding"),
    ("void fused_nerf_bwd_kernel<256, true>(float const*)",
     "K7 field backward, pass 1"),
    ("void fused_nerf_kernel<256, true>(float const*)", "K6 fused field"),
    ("void (anonymous namespace)::fused_nerf_bwd_tc_kernel<256>(float const*)",
     "K7 field backward, pass 1"),
    ("(anonymous namespace)::wgrad_tc_kernel(WJobs, float*, long long)",
     "K7 field backward, pass 2 (weights)"),
    ("(anonymous namespace)::wgrad_tc32_kernel(Jobs, float*, long long, "
     "long long)", "K7 field backward, pass 2 (weights)"),
    ("void (anonymous namespace)::head_grads_kernel<9>(float const*)",
     "K7 field backward, pass 2 (weights)"),
    ("(anonymous namespace)::round_pack_bwd_tc_kernel(float const*, BwdPack)",
     "K6 / K7 bf16 weight rounding"),
    ("(anonymous namespace)::pack_tc32_kernel(float const*, "
     "TcParamsOf<float>)", "K6 float32 weight pack"),
])
def test_train_kernel_groups(name, group):
    assert profile_eval.group_of(name, profile_train.GROUPS) == group


@pytest.mark.parametrize("tool", [profile_eval, profile_train, quality_gate])
def test_tools_refuse_without_cuda_at_either_precision(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--precision", "16"]) == 2
    assert tool.main() == 2


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::fused_nerf_tc_kernel<256>(float const*)",
    "void (anonymous namespace)::fused_nerf_tc32_kernel<256>(float const*)"])
@pytest.mark.parametrize("groups", [profile_eval.GROUPS, profile_train.GROUPS])
def test_tensor_core_field_kernel_is_k6(groups, name):
    assert profile_eval.group_of(name, groups) == "K6 fused field"



def test_probe_wgrad_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_wgrad.main() == 2
    assert probe_wgrad.main(["--points", "1000"]) == 2


def test_probe_trilinear_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_trilinear.main() == 2


class _Events:
    """A stand-in for ``torch.profiler.profile`` that records the given
    device events, each (kernel name, microseconds)."""

    recorded = []

    def __init__(self, **_):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *_):
        return False

    def events(self):
        from types import SimpleNamespace
        return [SimpleNamespace(name=n, device_type=probe_trilinear.DeviceType
                                .CUDA, time_range=SimpleNamespace(
                                    elapsed_us=lambda us=us: us))
                for n, us in _Events.recorded]


@pytest.mark.parametrize("events,ms,lost", [
    # two launches of b per call, 4 of its 100 events missed; copies and
    # spin kernels left out
    ([("a", 10.0)] * 50 + [("b", 2.0)] * 96 + [("Memcpy HtoD", 1.0)] * 7
     + [("spin_kernel", 5.0)] * 16, 0.014, {"b": 4}),
    ([("a", 10.0)] * 49 + [("a", 1000.0)], 0.010, {}),   # the median
    ([("a", 10.0)] * 30, None, None),                     # too many missed
])
def test_device_ms_counts_each_kernel_and_names_missed_events(
        monkeypatch, events, ms, lost):
    monkeypatch.setattr(probe_trilinear, "profile", _Events)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda _: None)
    monkeypatch.setattr(_Events, "recorded", events)
    if ms is None:
        with pytest.raises(RuntimeError, match="a 30"):
            probe_trilinear.device_ms(lambda: None)
        return
    assert probe_trilinear.device_ms(lambda: None) == pytest.approx(ms)
    assert probe_trilinear.device_ms.lost == lost


def test_device_ms_settles_for_a_stretch_of_host_time(monkeypatch):
    """Each session opens with at least SETTLE spin kernels, each waited
    for, and goes on with them until SETTLE_S of host time has passed; a
    refusal names the spin kernels the profiler saw."""
    spins = []
    monkeypatch.setattr(probe_trilinear, "profile", _Events)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", spins.append)
    clock = iter(range(10**6))
    monkeypatch.setattr(probe_trilinear.time, "perf_counter",
                        lambda: next(clock) * 1e-3)   # 1 ms a reading
    monkeypatch.setattr(_Events, "recorded", [("spin_kernel", 1.0)] * 3)
    # SETTLE (16) kernels, then one a reading until SETTLE_S (10 ms) has
    # passed: the clock is read once before them and once from the 16th on
    assert (probe_trilinear.SETTLE, probe_trilinear.SETTLE_S) == (16, 0.01)
    with pytest.raises(RuntimeError, match=r"\(and 3 of its 25 spin kernels"):
        probe_trilinear.device_ms(lambda: None, tries=1)
    assert len(spins) == 25


class _CardEvent:
    """A stand-in for ``torch.cuda.Event``: ``start.query()`` reads True
    (the stream already reached it) on the first ``late`` tries."""

    made = []
    late = 0

    def __init__(self, **_):
        _CardEvent.made.append(self)

    def record(self):
        pass

    def query(self):
        return len(_CardEvent.made) <= 2 * _CardEvent.late

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 5.0


@pytest.mark.parametrize("late,queued,tries", [(0, True, 1), (2, True, 3),
                                               (3, False, 3)])
def test_queued_ms_doubles_its_spin_until_the_calls_queue(
        monkeypatch, late, queued, tries):
    """queued_ms spins twice the host's time for the calls (+1 ms), doubles
    the spin while the stream reaches the first event before the host has
    queued the last call, and says whether its last reading was queued
    whole."""
    spins, calls = [], []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", spins.append)
    monkeypatch.setattr(torch.cuda, "Event", _CardEvent)
    monkeypatch.setattr(_CardEvent, "made", [])
    monkeypatch.setattr(_CardEvent, "late", late)
    monkeypatch.setattr(probe_trilinear._cycles_per_s, "rate", 1e9)
    clock = iter([0.0, 0.004])                      # the calls take 4 ms
    monkeypatch.setattr(probe_trilinear.time, "perf_counter",
                        lambda: next(clock))
    ms = probe_trilinear.queued_ms(lambda: calls.append(1), iters=10)
    assert ms == pytest.approx(0.5)                 # 5 ms over 10 calls
    assert probe_trilinear.queued_ms.queued is queued
    assert spins == [int(9e6 * 2 ** i) for i in range(tries)]
    assert len(calls) == 1 + 10 + 10 * tries


def _chip_smoke():
    """chip_smoke.py, the script at the repository's root, as a module."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_times_by_queued_ms_where_the_profiler_fails(
        monkeypatch, capsys):
    """chip_smoke's device_ms takes queued_ms's reading where the profiler
    records no usable events, logs it, and Rows.check names the numbers
    taken so in the row (``queued_ms_for``)."""
    chip_smoke = _chip_smoke()

    def profiled(fn):
        if fn() == "library":
            raise RuntimeError("device_ms: no events")
        return 1.0

    profiled.lost = {}
    monkeypatch.setattr(probe_trilinear, "device_ms", profiled)
    def queued(fn):
        return 2.0

    queued.queued = True
    monkeypatch.setattr(probe_trilinear, "queued_ms", queued)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    rows = chip_smoke.Rows()
    t = torch.ones(3)
    rows.check("k", "src", "rep", "c", lambda: t, lambda: t, lambda: t,
               1e-6, 1, 12, 3, timing="device",
               verified=(0.0, [(3,)]))
    assert rows.rows["k"]["ms"] == 1.0 and "queued_ms_for" not in rows.rows["k"]
    rows.check("k2", "src", "rep", "c", lambda: "kernel", lambda: "plain",
               lambda: "library", 1e-6, 1, 12, 3, timing="device",
               verified=(0.0, [(3,)]))
    r = rows.rows["k2"]
    assert (r["ms"], r["plain_ms"], r["library_ms"]) == (1.0, 1.0, 2.0)
    assert r["queued_ms_for"] == ["library_ms"]
    assert chip_smoke.device_ms.stand_ins == 1
    assert "timed instead by CUDA events" in capsys.readouterr().out
    out = rows.finish({"eval": {"c": 1}, "train": {"c": 1}})
    assert out[1]["queued_ms_for"] == ["library_ms"]
    assert "queued_ms_for" not in out[0]


def test_chip_smoke_pass2_gate_allows_rounding_not_a_lost_point(capsys):
    """chip_smoke's gate on K7 float32's pass 2: a chunk's sums over 65,536
    points that cancel, moved by a few float32 roundings of their terms'
    magnitude, pass where 1e-4 of the largest alone would not; the same
    sums with one point's term left out fail, naming the leaf."""
    chip_smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((65536, 4), generator=gen, dtype=torch.float64)
    d = torch.randn((65536, 1), generator=gen, dtype=torch.float64)
    d -= d.mean()                       # the sums cancel to ~1 from ~1e4
    twin = [(x.T @ d).float(), d.sum(0).float()]
    magnitude = [(x.abs().T @ d.abs()).float(), d.abs().sum(0).float()]
    names = ["w.weight", "w.bias"]
    rounded = [t + 0.25 * chip_smoke.F32_SUM_ROUNDING * m
               for t, m in zip(twin, magnitude)]
    assert float((rounded[1] - twin[1]).abs().max()) > 1e-4 * float(
        twin[1].abs().max())
    err, shapes = chip_smoke.hold_weight_grads("", names, rounded, twin,
                                               magnitude)
    assert shapes == [(4, 1), (1,)] and err > 0
    assert "nearest its limit w.bias 0.2" in capsys.readouterr().out
    lost = [(x[1:].T @ d[1:]).float(), d[1:].sum(0).float()]
    with pytest.raises(AssertionError, match="w.weight at .* w.bias at"):
        chip_smoke.hold_weight_grads("", names, lost, twin, magnitude)


def test_probe_device_ms_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_device_ms.main() == 2
    assert probe_device_ms.main(["--repeats", "2"]) == 2


def test_probe_bf16_sums_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_bf16_sums.main() == 2
    assert probe_bf16_sums.main(["--samples", "2"]) == 2


def test_probe_bf16_sums_reads_the_twin_as_its_own_sums():
    """The probe's readings, given the twin's forward values where K7's
    would be: no bf16 rounding or ReLU mask differs between the two, each
    trunk layer that reads h alone has K7's sum error equal to the twin's
    (the skip layer's successor, which reads [pts, h], is left out), and a
    gradient is at distance 0 from itself."""
    torch.manual_seed(0)
    field = NeRFField(4, 32, 6, 5, 8, skips=(1,), bf16=True,
                      sceneflow=False)
    wide = probe_bf16_sums.float64_twin(field)
    gen = torch.Generator().manual_seed(1)
    flat = [torch.randn((64, c), generator=gen) for c in (6, 8, 5)]
    g = torch.randn((64, field.out_ch), generator=gen)
    fwd = fused_mlp.forward_values_plain(field, *flat)
    fwd64 = fused_mlp.forward_values_plain(wide, *(t.double() for t in flat))
    flips = probe_bf16_sums.flips(field, fwd, fwd, fwd64)
    assert flips["K7"] == flips["twin"]
    sums = probe_bf16_sums.sums(field, fwd)
    assert sorted(sums) == ["z1", "z3"]
    for layer in sums.values():
        assert layer["K7"] == layer["twin"] < 1e-6
    _, offsets = fused_mlp.pack_weights(field)
    grads = fused_mlp.fused_nerf_backward_plain(field, *flat, g)
    dist = probe_bf16_sums.distances(field, offsets, grads, grads)
    linears = sum(isinstance(m, torch.nn.Linear) for m in field.modules())
    assert len(dist) == 3 + 2 * linears and set(dist.values()) == {0.0}


def _ray_points(rays, samples, dims, jitter, seed):
    """ndc [rays, samples, 3] of rays that cross the volume's depth in
    `samples` even steps (jittered by up to `jitter` of a step) while
    drifting slowly in x and y, some of them leaving the volume."""
    rng = np.random.default_rng(seed)
    D, _, _ = dims
    t = (np.arange(samples) + jitter * rng.random((rays, samples))) / samples
    z = t * samples / (D - 1) * 0.98 + 0.004
    xy0 = rng.random((rays, 1, 2)) * 1.2 - 0.1
    xy = xy0 + rng.normal(0.0, 0.05, (rays, 1, 2)) * t[..., None]
    return torch.from_numpy(np.concatenate([xy, z[..., None]], -1)
                            .astype(np.float32))


@pytest.mark.parametrize("jitter", [0.0, 1.0])
def test_k4_merge_model_sums_every_tap_once(jitter):
    """The probe's model of K4 (a point's upper corners handed to the next
    lane where its point lies one z plane up) gives the autograd twin's
    d_vol, on rays whose consecutive samples mostly share cells and on
    random points, and issues fewer atomics than taps where they share."""
    dims = (17, 9, 13)
    g = torch.Generator().manual_seed(3)
    ndc = _ray_points(40, 16, dims, jitter, 4)
    cot = torch.randn((*ndc.shape[:-1], 8), generator=g)
    vol = torch.randn((*dims, 8), generator=g)
    ref = trilinear.sample_volume_grads_plain(vol, ndc, cot)[0]
    work = probe_trilinear.k4_atomics(ndc, dims, cot)
    assert float((work["d_vol"] - ref.double()).abs().max()) <= 1e-5 * float(
        ref.abs().max())
    assert work["points"] == 40 * 16
    assert work["atomics"] < 0.8 * work["taps"]
    assert work["cells_per_warp"] <= work["atomics"] <= work["taps"]
    rnd = torch.rand((333, 3), generator=g) * 1.4 - 0.2
    cot = torch.randn((333, 8), generator=g)
    ref = trilinear.sample_volume_grads_plain(vol, rnd, cot)[0]
    work = probe_trilinear.k4_atomics(rnd, dims, cot)
    assert float((work["d_vol"] - ref.double()).abs().max()) <= 1e-5 * float(
        ref.abs().max())


def test_lines_per_load_counts_distinct_lines():
    """A 128-byte line holds 4 cells of 8 floats. On hand-built points,
    lanes along a ray's samples one z plane apart touch 32 lines per load;
    lanes across 32 rays one cell apart in x touch 8 (x0 = 0..31) or 9
    (x0 + 1 = 1..32)."""
    dims = (40, 4, 128)
    R, S = 32, 32
    x = torch.arange(R, dtype=torch.float32)[:, None].expand(R, S) + 0.5
    z = torch.arange(S, dtype=torch.float32)[None, :].expand(R, S) + 0.5
    y = torch.full((R, S), 1.5)
    ndc = torch.stack([x / (dims[2] - 1), y / (dims[1] - 1),
                       z / (dims[0] - 1)], -1)
    assert probe_trilinear.lines_per_load(ndc, dims, (1, 32)) == 32.0
    assert probe_trilinear.lines_per_load(ndc, dims, (32, 1)) == 8.5
    # 8 rays (2 or 3 lines) at each of 4 planes
    assert probe_trilinear.lines_per_load(ndc, dims, (8, 4)) == 10.0
    # ragged: 30 rays of 30 samples fill no warp of 8 x 4 evenly
    assert probe_trilinear.lines_per_load(ndc[:30, :30], dims, (8, 4)) > 0


@pytest.mark.parametrize("x,lines", [
    (4.5, {1: 16.0, 2: 8.0, 4: 4.0, 8: 4.0}),    # a row in one line
    (7.5, {1: 16.0, 2: 8.0, 4: 8.0, 8: 8.0}),    # a row across two lines
    (-0.5, {1: 8.0, 2: 4.0, 4: 4.0, 8: 4.0}),    # corner x0 = -1 out of range
    (127.5, {1: 8.0, 2: 4.0, 4: 4.0, 8: 4.0}),   # x0 = Wv - 1: x0 + 1 out
])
@pytest.mark.parametrize("n", [32, 7])
def test_k5_lines_counts_line_requests_per_point(x, lines, n):
    """A 128-byte line holds 4 cells of 8 floats, a row (the corners x0 and
    x0 + 1 of one (z, y)) 64 bytes. Points two z planes apart share no line.
    One thread per point loads a float4 of one corner per load: 16 loads, a
    line each (8 where half the corners are out of range). Four lanes per
    point load a row per load: 4 loads, one line each, or two where the row
    crosses a line (x0 % 4 == 3). Counts that fill no warp give the same."""
    dims = (80, 4, 128)
    z = 2.0 * torch.arange(n, dtype=torch.float32) + 0.5
    ndc = torch.stack([torch.full((n,), x / (dims[2] - 1)),
                       torch.full((n,), 1.5 / (dims[1] - 1)),
                       z / (dims[0] - 1)], -1)
    for lanes, want in lines.items():
        assert probe_trilinear.k5_lines(ndc, dims, lanes) == want
    # every point at one place whose rows each lie in one line: each load
    # touches one line for the whole warp
    same = torch.tensor([[4.5 / (dims[2] - 1), 1.5 / (dims[1] - 1), 0.5 / 79]]
                        ).expand(32, 3)
    for lanes in (1, 4):
        assert probe_trilinear.k5_lines(same, dims, lanes) == 0.5
