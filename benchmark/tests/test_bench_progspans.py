"""The reduction of the program's spans (vkbench/progspans.py) on a
hand-built window: device idle goes to every program span open when a
gap began, ancestors included; syncs go to their innermost program span;
device work and syncs inside ``bench.own`` are left out; the gaps are
``trace.summarize``'s."""

from types import SimpleNamespace

import pytest

from vkbench import progspans, trace


class Event:
    """A profiler event as ``trace`` reads one."""

    def __init__(self, name, start, end, kind, corr=0):
        self._name, self._start, self._end = name, start, end
        self._kind, self._corr = kind, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def activity_type(self):
        return self._kind

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._corr


def _profile(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _span(name, start, end):
    kind = "user_annotation" if name.startswith("bench.") else "cpu_op"
    return Event(name, start, end, kind)


def _kernel(start, end, launched, corr):
    return [Event("cudaLaunchKernel", launched, launched + 2, "cuda_runtime",
                  corr), Event(f"kernel{corr}", start, end, "kernel", corr)]


def _sync(t):
    return Event("cudaStreamSynchronize", t, t + 1, "cuda_runtime")


EVENTS = [
    _span("bench.window", 0, 1000), _span("bench.frame", 0, 900),
    _span("bench.masked", 100, 600), _span("bench.own", 700, 800),
    _span("vkr.frame", 10, 890), _span("vkr.masked", 110, 590),
    _span("vkr.masked.accept", 200, 300), _span("vkr.masked.tail", 300, 580),
    _span("vkr.masked.accept", 350, 450),
    *_kernel(20, 100, 15, 1), *_kernel(250, 260, 210, 2),
    *_kernel(400, 420, 360, 3), *_kernel(710, 790, 705, 4),   # bench.own
    *_kernel(850, 880, 840, 5),
    _sync(220), _sync(320), _sync(380), _sync(720), _sync(950), _sync(1200),
]


def test_idle_goes_to_every_open_span_and_syncs_to_the_innermost():
    got = progspans.summarize(_profile(EVENTS))
    # gaps: 0-20 (no program span), 100-250 (frame), 260-400 (round 0's
    # accept), 420-850 (the tail's accept; the own kernel left out),
    # 880-1000 (frame)
    assert got["idle_s"] == pytest.approx({
        "vkr.frame": 840e-9, "vkr.masked": 570e-9,
        "vkr.masked.accept": 570e-9, "vkr.masked.tail": 430e-9})
    assert got["syncs"] == {"frame/masked/masked.accept": 1,
                            "frame/masked/masked.tail": 1,
                            "frame/masked/masked.tail/masked.accept": 1,
                            progspans.OUTSIDE: 1}
    # the continuation round: its host time, the gap that began in its
    # accept, its two syncs
    assert got["instances"] == {"masked.tail#0": pytest.approx(
        (280e-9, 430e-9, 2))}
    assert got["frame_idle_s"] == pytest.approx(860e-9)
    assert got["covered_idle_s"] == pytest.approx(840e-9)


def test_the_gaps_are_the_benchmark_spans_gaps():
    prof = _profile(EVENTS)
    summary, got = trace.summarize(prof), progspans.summarize(prof)
    idle = dict(summary["idle_gaps"])
    assert summary["window_s"] - summary["busy_s"] == pytest.approx(
        sum(idle.values()))
    assert idle["bench.masked"] == pytest.approx(720e-9)
    assert got["frame_idle_s"] == pytest.approx(
        idle["bench.masked"] + idle["bench.frame"])
    assert summary["syncs"] == sum(got["syncs"].values())


def test_gaps_begun_in_the_benchmarks_own_capture_are_left_out():
    # a capture inside the continuation round; the program's kernel at
    # 505-510 ends inside it, so the gap 510-850 begins there
    prof = _profile(EVENTS + [_span("bench.own", 500, 520),
                              *_kernel(505, 510, 455, 6)])
    got, summary = progspans.summarize(prof), trace.summarize(prof)
    assert dict(summary["idle_gaps"])["bench.own"] == pytest.approx(340e-9)
    # gaps 100-250, 260-400, 420-505, 880-1000; not 510-850
    assert got["idle_s"] == pytest.approx({
        "vkr.frame": 495e-9, "vkr.masked": 225e-9,
        "vkr.masked.accept": 225e-9, "vkr.masked.tail": 85e-9})
    assert got["instances"]["masked.tail#0"][1] == pytest.approx(85e-9)


def test_readers_per_frame_and_without_program_spans():
    run = SimpleNamespace(frames=2, progspans=progspans.summarize(
        _profile(EVENTS)), counters={"frames": 2, "masked.rounds": 5})
    assert progspans.idle_ms(run, "vkr.masked") == pytest.approx(570e-6 / 2)
    assert progspans.syncs_per_frame(run, "masked") == 1.5
    assert progspans.counter_per_frame(run, "masked.rounds") == 2.5
    assert len(progspans.lines(run)) == 4
    older = [e for e in EVENTS if not e.name().startswith("vkr.")]
    run = SimpleNamespace(frames=2, progspans=progspans.summarize(
        _profile(older)), counters=None)
    assert progspans.idle_ms(run, "vkr.masked") is None
    assert progspans.syncs_per_frame(run, "masked") is None
    assert progspans.counter_per_frame(run, "masked.rounds") is None
    assert progspans.lines(run) == []


def test_readers_take_the_profiler_of_the_reporting_run(capsys):
    """The first reader of a traced run reduces the profiler that a
    calling frame holds (``cell.run_cell``'s ``prof``), keeps the
    reduction and the program's counters on the run and prints the
    stderr lines once."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vk_renderer_tpu_torch.utils import tracing

    def report(run):     # as cell._result, inside run_cell
        return [progspans.counter_per_frame(run, "frames"),
                progspans.idle_ms(run, "vkr.frame")]

    tracing.reset()
    tracing.count("frames", 5)       # no profiler on: not counted
    prof = profile(activities=[ProfilerActivity.CPU])
    with prof:
        with torch.profiler.record_function("bench.window"):
            for _ in range(2):
                with tracing.span("frame"):
                    tracing.count("frames", 1)
                    torch.ones(4).sum()
    run = SimpleNamespace(frames=2)
    try:
        # no device activity on the CPU: no gaps, so no idle to report
        assert report(run) == [1.0, None]
        assert run.counters == {"frames": 2}
        assert report(run) == [1.0, None]
    finally:
        tracing.reset()
    err = capsys.readouterr().err.splitlines()
    assert err == ["program counters over the window (2 frames): frames 2"]
