"""The port's spans and counters (utils/tracing.py) on the CPU at 64x32,
on the glTF fixture (a MASK material) and the transparent cube: nothing
is recorded and the frame is unchanged with no profiler on; under a
profiler every stage's ``vkr.*`` span appears, nested as the calls
nest, and the counters match the frames and rounds that ran.  Imports
no JAX."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vk_renderer_tpu_torch.graph import driver, frame
from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
from vk_renderer_tpu_torch.scene import procedural
from vk_renderer_tpu_torch.scene.assembly import SceneBuilder
from vk_renderer_tpu_torch.scene.camera import Camera
from vk_renderer_tpu_torch.scene.types import scene_to_torch
from vk_renderer_tpu_torch.utils import tracing

import torch_threads  # noqa: F401  (bounds torch's threads)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "textured_box", "scene.gltf")

# span -> the spans that may hold it (None: no program span)
PARENTS = {
    "inputs": {None}, "frame": {None},
    "shadow": {"frame"},
    "classifier": {"frame"}, "view": {"frame"},
    "setup": {"view"}, "bin": {"view", "shadow"},
    "records": {"view", "shadow"}, "raster_opaque": {"view"},
    "masked": {"view"}, "masked_kraster0": {"masked"},
    "masked.accept": {"masked", "masked.tail"}, "masked.tail": {"masked"},
    "gbuffer": {"view", "transparent"}, "shade": {"view"},
    "shade.classify": {"shade", "transparent"}, "compose": {"view"},
    "sky": {"compose"}, "transparent": {"view"}, "tonemap": {"view"},
    "to_u8": {"view"},
}
MASKED = {"masked", "masked_kraster0", "masked.accept", "masked.tail"}


def _fixture():
    b = SceneBuilder()
    b.load_gltf(FIXTURE, "fixture")
    b.cubemap = procedural.make_sky_cubemap(16)
    return b.build(), Camera()


def _cube():
    """The cube with its -y face made additive transparent, seen from
    below (tests/test_torch_frame.py's transparent cube)."""
    host = procedural.build_cube_scene().build()
    host.n_opaque -= 2
    host.n_transparent = 2
    cam = Camera(position=np.array([0.1, -2.2, -4.6], np.float32))
    cam.pitch = 1.3
    return host, cam


def _setup(make, **frame_kw):
    host, cam = make()
    scene = scene_to_torch(host, "cpu")
    settings = RenderSettings(enable_shadows=True, shadow_mode=3,
                              enable_postprocess=True)
    cfg = driver.config_from_settings(settings, 64, 32, shadow_size=64,
                                      **frame_kw)
    return scene, cam, settings, cfg


def _render(scene, cam, settings, cfg):
    return driver.render(scene, cam, settings, cfg)


def _program_spans(prof):
    """(span, the innermost program span holding it) for every ``vkr.*``
    event of the profile, nested by time as the benchmark's trace
    reduction nests them."""
    n = len(tracing.PREFIX)
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.name()[n:])
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(tracing.PREFIX)),
                   key=lambda sp: (sp[0], -sp[1]))
    out, stack = [], []
    for s0, s1, name in spans:
        while stack and stack[-1][0] <= s0:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append((s1, name))
    return out


def test_off_records_nothing_and_leaves_the_frame_unchanged(monkeypatch):
    """No profiler: span() is the one shared null context and never
    builds a span (the span type raises here), count() keeps nothing;
    the frame equals, bit for bit, the frame rendered under a
    profiler."""
    scene, cam, settings, cfg = _setup(_fixture)
    tracing.reset()
    with monkeypatch.context() as m:
        def refuse(*_):
            raise AssertionError("a span was built with no profiler on")
        m.setattr(tracing, "_RecordFunctionFast", refuse)
        assert tracing.span("frame") is tracing.span("masked")
        tracing.count("frames", 1)
        off = _render(scene, cam, settings, cfg)
    assert tracing.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        on = _render(scene, cam, settings, cfg)
    assert tracing.counters()["frames"] == 1
    tracing.reset()
    for key in ("color", "depth", "stats_vec", "color_u8"):
        assert torch.equal(off[key], on[key]), key


@pytest.mark.parametrize("make,tail_rounds,absent", [
    (_fixture, 0, {"transparent", "masked.tail"}),
    (_fixture, 3, {"transparent"}),
    (_cube, 3, MASKED)], ids=["fixture_one_round", "fixture", "cube"])
def test_spans_nest_and_counters_match(make, tail_rounds, absent):
    scene, cam, settings, cfg = _setup(make)
    cfg = dataclasses.replace(cfg, masked_tail_rounds=tail_rounds)
    frames = 2
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(frames):
            _render(scene, cam, settings, cfg)
    counts = tracing.counters()
    tracing.reset()
    assert tracing.counters() == {}

    seen = _program_spans(prof)
    assert {name for name, _ in seen} == set(PARENTS) - absent
    for name, parent in seen:
        assert parent in PARENTS[name], (name, parent)
    per_frame = {name: sum(1 for n, _ in seen if n == name) / frames
                 for name in ("frame", "inputs", "shadow")}
    assert per_frame == {"frame": 1, "inputs": 1, "shadow": 1}

    assert counts["frames"] == frames
    # the cascades render as one batch a frame, counted once per call
    assert counts["shadow.cascades"] == frames * frame.NUM_CASCADES
    if "masked" in absent:
        assert not {"masked.rounds", "masked.alpha_px"} & set(counts)
        return
    rounds = counts["masked.rounds"]
    assert frames <= rounds <= frames * (1 + tail_rounds)
    if tail_rounds == 0:
        assert rounds == frames
    assert counts["masked.alpha_px"] > 0
    assert counts["shade.uncertain_px"] >= 0


def test_device_counter_adds_reads_and_clears(monkeypatch):
    """A device-fed counter: None and no allocation with no profiler on;
    under one, one i64 scalar per (name, device) that the work adds into,
    summed with the host's counts of the same name by counters(), and
    cleared by reset()."""
    tracing.reset()
    with monkeypatch.context() as m:
        def refuse(*_, **__):
            raise AssertionError("a counter was allocated with no "
                                 "profiler on")
        m.setattr(torch, "zeros", refuse)
        assert tracing.device_counter("masked.alpha_px", "cpu") is None
    assert tracing.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        c = tracing.device_counter("masked.alpha_px", "cpu")
        assert c.dtype == torch.int64 and c.shape == () and int(c) == 0
        c.add_(3)
        assert tracing.device_counter("masked.alpha_px", "cpu") is c
        tracing.device_counter("masked.alpha_px", "cpu").add_(4)
        tracing.count("masked.alpha_px", 5)
    assert tracing.counters() == {"masked.alpha_px": 12}
    tracing.reset()
    assert tracing.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert int(tracing.device_counter("masked.alpha_px", "cpu")) == 0
    tracing.reset()


def test_alpha_tests_add_up_across_frames():
    """The masked pass feeds masked.alpha_px through its device counter:
    two frames of one view count twice what one frame counts, and the
    rounds likewise."""
    scene, cam, settings, cfg = _setup(_fixture)
    cfg = dataclasses.replace(cfg, masked_tail_rounds=3)
    got = []
    for frames in (1, 2):
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(frames):
                _render(scene, cam, settings, cfg)
        got.append(tracing.counters())
    tracing.reset()
    assert got[0]["masked.alpha_px"] > 0
    for key in ("masked.alpha_px", "masked.rounds", "frames"):
        assert got[1][key] == 2 * got[0][key], key
