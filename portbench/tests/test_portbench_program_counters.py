"""The readers of the engine's own counters (``InferenceEngine.stats()``):
on synthetic contexts, on a program whose engine keeps no such counter,
and in a traced serving run on the CPU."""

import pytest

import pb_cells
from portbench import core

COUNTED = {"requests": 11, "batches": 4, "padded_slots": 1,
           "dispatches_by_bucket": {2: 1, 4: 2}, "rows_dispatched": 9,
           "queue_waits": 9, "queue_wait_s_total": 0.45}
OLDER = {"requests": 11, "batches": 4, "padded_slots": 1}


@pytest.mark.parametrize("name,want", [
    ("engine.queue_wait_ms.fused", 50.0),
    ("engine.queue_wait_ms.b128", 50.0),
    ("engine.batch_fill.fused", 0.9),
    ("engine.batch_fill.b128", 0.9)])
def test_reader_on_the_counters(name, want):
    read = core.reader(name)
    assert read({"stats": COUNTED}) == pytest.approx(want)


def test_direct_dispatches_leave_the_mean_wait_alone():
    """Rows of direct ``transfer_batch`` calls waited in no queue: the
    mean wait is over the requests the dispatch thread took."""
    direct = dict(COUNTED, rows_dispatched=12, padded_slots=4,
                  dispatches_by_bucket={2: 1, 4: 3})
    assert core.reader("engine.queue_wait_ms.fused")(
        {"stats": direct}) == pytest.approx(50.0)
    assert core.reader("engine.batch_fill.fused")(
        {"stats": direct}) == pytest.approx(0.75)


@pytest.mark.parametrize("name", ["engine.queue_wait_ms.fused",
                                  "engine.batch_fill.b128"])
@pytest.mark.parametrize("stats", [OLDER, None, dict(
    COUNTED, rows_dispatched=0, queue_waits=0, dispatches_by_bucket={})])
def test_reader_finds_nothing_without_the_counters(name, stats):
    ctx = {} if stats is None else {"stats": stats}
    assert core.reader(name)(ctx) is None


def test_traced_serving_run_reports_the_counters():
    result = pb_cells.run(pb_cells.serve_cell(), trace=True)
    metrics = result["metrics"]
    fill = metrics["engine.batch_fill.fused"]
    assert fill["unit"] == "fraction" and 0.0 < fill["value"] <= 1.0
    wait = metrics["engine.queue_wait_ms.fused"]
    assert wait["unit"] == "ms" and wait["value"] >= 0.0
