"""``stages.summarize`` on synthetic event lists, and on a traced CPU run:
idle split by stage sums to the window's idle, a kernel goes to the
innermost span around its launch, and a trace without program spans reads
as ``devtrace`` reads it."""

from dataclasses import dataclass

import pytest

import devtrace
import stages
from test_bench_harness import SEED, blocks_traffic, narrow, spot_traffic

CUDA, CPU = "DeviceType.CUDA", "DeviceType.CPU"


@dataclass
class Range:
    start: float
    end: float


@dataclass
class Ev:
    name: str
    start: float
    end: float
    device_type: str = CPU
    id: int = 0
    is_user_annotation: bool = False

    @property
    def time_range(self):
        return Range(self.start, self.end)


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def kernel(name, a, b, corr, launch):
    """A device operation over [a, b) µs and the runtime call at ``launch``
    that launched it."""
    return [Ev(name, a, b, CUDA, corr), Ev("cudaLaunchKernel", launch, launch + 1, CPU, corr)]


def tick_trace(with_program=True):
    """A 1000 µs window, one ``bench.step`` over [0, 1000): a tick whose
    resolve [100, 300) and write-back [700, 1000) leave the device idle,
    and a layer [300, 700) whose kernel runs [320, 700)."""
    ev = [Ev("bench.window", 0, 1000), Ev("bench.step", 0, 1000)]
    ev += kernel("fft", 0, 100, 1, 0)  # launched before any program span
    ev += kernel("elementwise_kernel<direct_copy_kernel_cuda>", 320, 700, 2, 310)
    if with_program:
        ev += [Ev("znni.engine.step", 50, 1000), Ev("znni.exec.resolve", 100, 300),
               Ev("znni.exec.layer.2", 300, 700), Ev("znni.engine.write_back", 700, 1000),
               # the device side of a span, as CUPTI records it
               Ev("znni.exec.layer.2", 320, 700, CUDA, 0, True)]
    return ev


def test_a_gap_split_across_stages_sums_to_the_window_idle():
    s = stages.summarize(tick_trace())
    old = devtrace.summarize(Prof(tick_trace()))
    idle = old["window_s"] - old["busy_s"]
    assert idle == pytest.approx(sum(s["idle_by_stage"].values()), abs=1e-12)
    # [100, 300) resolve, [300, 320) the layer before its kernel starts,
    # [700, 1000) write-back
    assert s["idle_by_stage"] == pytest.approx(
        {"exec.resolve": 200e-6, "exec.layer.2": 20e-6, "engine.write_back": 300e-6})
    assert sorted(s["idle_gaps"]) == sorted([["step/exec.resolve", 220e-6],
                                             ["step/engine.write_back", 300e-6]])


def test_a_kernel_goes_to_the_innermost_span_around_its_launch():
    s = stages.summarize(tick_trace())
    assert s["stage_device_s"] == pytest.approx({"other": 100e-6, "exec.layer.2": 380e-6})
    assert s["stage_copy_s"] == pytest.approx({"exec.layer.2": 380e-6})
    assert s["stage_calls"] == {"engine.step": 1, "exec.resolve": 1, "exec.layer.2": 1,
                                "engine.write_back": 1}
    assert s["stage_host_s"]["engine.step"] == pytest.approx(950e-6)
    # the tick less its device stage: 950 - 400 µs
    assert s["ticks"] == 1 and s["tick_host_ms"] == pytest.approx(0.55)


def test_without_program_spans_the_labels_are_devtraces():
    bare = tick_trace(with_program=False)
    s, old = stages.summarize(bare), devtrace.summarize(Prof(bare))
    assert s["idle_gaps"] == old["idle_gaps"]
    assert s["idle_by_stage"] == old["idle_by_span"]
    assert s["stage_host_s"] == {} and s["ticks"] == 0 and s["tick_host_ms"] is None


def test_program_spans_change_nothing_devtrace_reads():
    assert devtrace.summarize(Prof(tick_trace())) == devtrace.summarize(
        Prof(tick_trace(with_program=False)))


def test_nested_spans_sharing_an_edge_take_the_inner_name():
    spans = [(0, 10, "outer"), (0, 4, "a"), (4, 10, "b"), (4, 4, "empty")]
    assert stages._innermost(spans, -2, 12) == [
        [-2, 0, None], [0, 4, "a"], [4, 10, "b"], [10, 12, None]]


def test_no_window_reads_nothing():
    assert stages.summarize([Ev("znni.engine.step", 0, 1)]) is None


@pytest.mark.parametrize("cell", ["n337.blocks", "n337.spot"])
def test_a_traced_cpu_run_reads_its_stages(cell):
    import stage_table

    traffic = blocks_traffic((2, 1, 1)) if cell.endswith("blocks") else spot_traffic()
    result, s = stage_table.traced_run(cell, SEED, 1.0, "cpu", config=narrow(),
                                       traffic=traffic)
    assert result["correct"] and s is not None
    idle = result["device"]["window_s"] - result["device"]["busy_s"]
    assert sum(s["idle_by_stage"].values()) == pytest.approx(idle, abs=1e-3)
    assert s["ticks"] == s["stage_calls"]["engine.step"] > 0
    assert {"engine.schedule", "exec.resolve", "exec.layer0", "exec.copy_back",
            "engine.write_back"} <= set(s["stage_calls"])
    assert 0 < s["tick_host_ms"] < 1e3 * s["stage_host_s"]["engine.step"] / s["ticks"]
    rows = stage_table.table([s]).splitlines()
    assert rows[0].split()[:2] == ["stage", "host"]
    assert {r.split()[0] for r in rows[1:]} == (
        set(s["stage_calls"]) | set(s["idle_by_stage"]) | set(s["stage_device_s"]))


@pytest.mark.card
def test_a_short_traced_run_on_the_card_puts_its_time_to_stages():
    import torch

    import stage_table

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result, s = stage_table.traced_run("n337.spot", 2147484003, 3.0)
    assert result["correct"] and s is not None and s["ticks"] > 0
    idle = result["device"]["window_s"] - result["device"]["busy_s"]
    assert sum(s["idle_by_stage"].values()) == pytest.approx(idle, abs=1e-3)
    device = sum(s["stage_device_s"].values())
    assert s["stage_device_s"].get("other", 0.0) <= 0.05 * device
    assert s["stage_copy_s"] and 0 < s["tick_host_ms"] < 1e3
