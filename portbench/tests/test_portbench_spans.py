"""The readers of the program's spans on hand-made records and a hand-made
trace: each reads what its file says, and nothing (None) where the program
has no spans, the segment has no steps or the run had no card."""

import pytest

from portbench.manifest import Manifest
from portbench.trace import WINDOW, Trace
from txt2vid_tpu_torch.utils import profiling

S = 1_000_000_000      # ns a second


def record(i, name, parent, step, host, device=None, **attrs):
    """A finished span: host (start, end) in s, device (start, end) in ms."""
    r = profiling.Span(i, name, parent, step, attrs, int(host[0] * S), int(host[1] * S))
    if device is not None:
        r.device_start_ms, r.device_end_ms = device
    return r


def step_records(first, step, gp, host, t0, phases, device=True):
    """A trainer.step at id `first` and its phases, each (name, start, end)
    in ms from t0, with a step.optim in the last 50 ms of step.d and step.g;
    its step.d tagged with `gp`."""
    dev = (lambda a, b: (t0 + a, t0 + b)) if device else (lambda a, b: None)
    out = [record(first, "trainer.step", None, step, host, dev(phases[0][1], phases[-1][2]))]
    for name, a, b in phases:
        attrs = {"gp": gp} if name == "step.d" else {}
        out.append(record(first + len(out), name, first, step, host, dev(a, b), **attrs))
        if name in ("step.d", "step.g"):
            out.append(record(first + len(out), "step.optim", out[-1].id, step, host,
                              dev(b - 50, b - 10)))
    return out


def records(device=True):
    """A GP step (5) and a plain step (6) in a window of 10 s, each after
    its fetch and followed by its EMA; the fetch that ends the dataset after
    the window."""
    recs = [record(0, "trainer.data", None, None, (0.50, 0.51))]
    recs += step_records(1, 5, True, (0.52, 2.5), 0.0, [
        ("step.draw", 0, 10), ("step.encode", 10, 20), ("step.g_forward", 20, 300),
        ("step.d", 300, 1500), ("step.g", 1500, 2000)], device)
    recs.append(record(len(recs), "trainer.ema", None, 5, (2.5, 2.51),
                       (2000, 2005) if device else None))
    recs.append(record(len(recs), "trainer.data", None, None, (2.51, 2.516)))
    recs += step_records(len(recs), 6, False, (2.52, 4.0), 2010.0, [
        ("step.draw", 0, 10), ("step.encode", 10, 20), ("step.g_forward", 20, 290),
        ("step.d", 290, 890), ("step.g", 890, 1290)], device)
    recs.append(record(len(recs), "trainer.ema", None, 6, (4.0, 4.01),
                       (3300, 3303) if device else None))
    recs.append(record(len(recs), "trainer.data", None, None, (9.9, 10.5)))
    return recs


def trace():
    host = [("trainer.step", 0.52, 2.5), ("trainer.step", 2.52, 4.0),
            ("cudaStreamSynchronize", 0.6, 0.61), ("cudaStreamSynchronize", 0.7, 0.71),
            ("cudaDeviceSynchronize", 1.0, 1.1), ("cudaStreamSynchronize", 2.7, 2.71),
            ("cudaStreamSynchronize", 2.51, 2.515),               # between the steps
            ("cudaLaunchKernel", 0.8, 0.8001), ("cudaLaunchKernel", 0.9, 0.9001),
            ("cudaLaunchKernel", 3.0, 3.0001), ("cuLaunchKernel", 3.1, 3.1001),
            ("cudaLaunchKernel", 5.0, 5.0001), ("aten::conv3d", 0.8, 0.9)]
    return Trace([(WINDOW, False, True, 0.0, 10.0), ("k", True, False, 0.6, 2.0)]
                 + [(n, False, n.startswith(("trainer.", "step.")), s, e) for n, s, e in host])


READINGS = {"loader_wait_ms.train_f32": 8.0,              # (10 + 6) / 2
            "syncs_per_step.train_f32": 2.0,              # (3 + 1) / 2
            "launches_per_step.train_f32": 2.0,           # (2 + 2) / 2
            "gp_step_device_ms.train_f32": 2000.0,
            "d_phase_device_ms.train_f32": 560.0,         # 600 - 40
            "g_phase_device_ms.train_f32": 630.0,         # 270 + 400 - 40
            "optimizer_device_ms.train_f32": 84.0,        # (40 + 40 + 5 + 40 + 40 + 3) / 2
            "program_setup_s": 2.0}
TOTALS = {"setup.models": 1.25, "setup.data": 0.25, "setup.kernels": 0.5, "trainer.data": 3.0}


def read(name, ctx):
    return Manifest().reader({"name": name}).read(ctx)


@pytest.fixture
def program(monkeypatch):
    def use(recs, totals=TOTALS):
        monkeypatch.setattr(profiling._rec, "records", recs)
        monkeypatch.setattr(profiling, "totals", lambda: totals)
    return use


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readers_read_the_spans(program, name):
    program(records())
    assert read(name, {"trace": trace(), "layer": {}}) == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "totals")
    bare = Trace([(WINDOW, False, True, 0.0, 10.0), ("k", True, False, 0.6, 2.0),
                  ("cudaLaunchKernel", False, False, 0.5, 0.6)])
    assert read(name, {"trace": bare, "layer": {}}) is None


@pytest.mark.parametrize("name", ["gp_step_device_ms.train_f32", "d_phase_device_ms.train_f32",
                                  "g_phase_device_ms.train_f32",
                                  "optimizer_device_ms.train_f32"])
def test_device_readers_need_a_card(program, name):
    program(records(device=False))
    assert read(name, {"trace": trace(), "layer": {}}) is None


def test_the_segment_is_the_window(program):
    from portbench.spans import segment
    program(records())
    kept = segment({"trace": trace()})
    assert [r.name for r in kept].count("trainer.data") == 2
    assert len(kept) == len(records()) - 1
    program([])
    assert segment({"trace": trace()}) is None


def test_loader_wait_is_the_median(program):
    """An epoch's restart in one of three fetches moves the reading not at
    all: the median of 10, 6 and 42 ms."""
    recs = records()
    restart = [r for r in recs if r.name == "trainer.data"][-1]
    restart.start_ns, restart.end_ns = int(4.5 * S), int(4.542 * S)
    recs.append(record(len(recs), "trainer.step", None, 7, (4.6, 5.0)))
    program(recs)
    assert read("loader_wait_ms.train_f32", {"trace": trace(), "layer": {}}) == pytest.approx(10.0)


def test_gp_steps_are_those_with_a_penalised_d_update(program):
    """A step is a GP step by its step.d's tag: under a chunk of two inner
    steps, one penalised update makes the call a GP step."""
    from portbench.spans import steps
    recs = records()
    program(recs)
    assert [s.step for s in steps(recs, gp=True)] == [5]
    assert [s.step for s in steps(recs, gp=False)] == [6]
    chunk = step_records(0, 2, False, (0.5, 1.0), 0.0, [("step.d", 0, 10)])
    chunk += step_records(len(chunk), 2, True, (0.5, 1.0), 0.0, [("step.d", 10, 20)])[1:]
    for r in chunk[1:]:
        r.parent = 0 if r.name == "step.d" else r.parent
    assert [s.step for s in steps(chunk, gp=True)] == [2] and steps(chunk, gp=False) == []
