"""The program tracer (``utils/profiling.py``) and where the port opens its
spans, on the CPU.  Every assertion is on structure or counts: which
spans exist, their nesting, their attributes and the counters; no
duration is held to a threshold.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.datasets import (
    DevicePairLoader, DeviceResidentPairs, build_pack, generate_pairings,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import LDM
from music_style_transfer_ldm_tpu_torch.serving.engine import (
    EngineConfig, InferenceEngine,
)
from music_style_transfer_ldm_tpu_torch.training.train_ldm import LDMTrainer
from music_style_transfer_ldm_tpu_torch.utils import profiling
from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray


@pytest.fixture(autouse=True)
def _off_afterwards():
    yield
    profiling.disable()


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _names(tracer):
    return [r.name for r in tracer.spans()]


def test_off_is_one_shared_noop_that_records_nothing():
    assert profiling.active() is None
    first, second = profiling.span("a"), profiling.span(
        "b", device=torch.device("cpu"), x=1)
    assert first is second
    tracer = profiling.Tracer()
    profiling.enable(tracer)
    assert profiling.disable() is tracer
    with profiling.span("a") as sp:
        sp.set(y=2)
        profiling.count("n", 5)
        profiling.record("w", 0.0, 1.0)
    assert tracer.spans() == [] and tracer.counters == {}


def test_nesting_parents_attributes_and_counters():
    tracer = profiling.enable()
    with profiling.span("outer", k="v") as outer:
        with profiling.span("inner"):
            profiling.count("hits")
            profiling.count("hits", 2)
        outer.set(late=1)
        profiling.record("waited", 1.0, 2.0, trace_id=3)
    with pytest.raises(ValueError):
        with profiling.span("failing"):
            raise ValueError("x")
    profiling.disable()
    inner, waited, outer, failing = tracer.spans()
    assert [r.name for r in (inner, waited, outer, failing)] == [
        "inner", "waited", "outer", "failing"]
    assert outer.parent_id is None and failing.parent_id is None
    assert inner.parent_id == outer.span_id == waited.parent_id
    assert len({inner.span_id, outer.span_id, waited.span_id,
                failing.span_id}) == 4
    assert waited.trace_id == 3
    assert outer.trace_id is None and inner.trace_id is None
    assert outer.attrs == {"k": "v", "late": 1}
    assert (waited.start, waited.end) == (1.0, 2.0)
    assert failing.attrs == {}
    assert tracer.counters == {"hits": 3}
    assert tracer.spans("inner") == [inner]


def test_threads_keep_their_own_stacks():
    tracer = profiling.enable()
    inside, leave = threading.Event(), threading.Event()

    def other():
        with profiling.span("thread.outer"):
            inside.set()
            leave.wait(60)
            with profiling.span("thread.inner"):
                pass

    worker = threading.Thread(target=other)
    with profiling.span("main.outer"):
        worker.start()
        assert inside.wait(60)
        with profiling.span("main.inner"):
            leave.set()
            worker.join(60)
    by = {r.name: r for r in tracer.spans()}
    assert len(by) == 4
    assert by["main.inner"].parent_id == by["main.outer"].span_id
    assert by["thread.inner"].parent_id == by["thread.outer"].span_id
    assert by["thread.outer"].parent_id is None


def test_many_threads_lose_no_span_and_no_count():
    """More threads than cores, switching often: every span is kept and
    every count added."""
    tracer = profiling.enable()
    n_threads, n_each = 16, 200

    def work():
        for _ in range(n_each):
            with profiling.span("s"):
                profiling.count("n")
            profiling.count("m", 2)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    spans = tracer.spans()
    assert len(spans) == n_threads * n_each
    assert len({r.span_id for r in spans}) == len(spans)
    assert all(r.parent_id is None for r in spans)
    assert tracer.counters == {"n": n_threads * n_each,
                               "m": 2 * n_threads * n_each}


def test_ring_keeps_the_newest():
    tracer = profiling.enable(profiling.Tracer(capacity=4))
    for i in range(10):
        with profiling.span("s", i=i):
            pass
    assert [r.attrs["i"] for r in tracer.spans()] == [6, 7, 8, 9]


def test_device_time_is_none_off_the_card_and_the_clock_is_perf_counter():
    tracer = profiling.enable()
    before = time.perf_counter()
    with profiling.span("host", device=torch.device("cpu")):
        pass
    with profiling.span("current", device=torch.device(
            "cuda" if torch.cuda.is_available() else "cpu")):
        pass
    after = time.perf_counter()
    assert tracer.resolve() == 0
    host, current = tracer.spans()
    assert host.device_ms is None and host.events is None
    assert before <= host.start <= host.end <= current.start <= after
    if not torch.cuda.is_available():
        assert current.device_ms is None


def _small_ldm(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LDM(num_timesteps=20)
    return model.requires_grad_(False).eval()


def test_one_dispatch_of_three_requests_at_bucket_four():
    eng = InferenceEngine(_small_ldm(), EngineConfig(
        sampler="fused", steps=12, griffin_lim_iters=4, nnls_iters=8,
        batch_buckets=(2, 4)))
    eng.warmup()
    rng = np.random.RandomState(3)
    images = rng.rand(6, 128, 128, 1).astype(np.float32)
    before = eng.stats()
    tracer = profiling.enable()
    # queued before the dispatch thread starts, so one dispatch takes all
    waiters = [eng.submit(images[i], images[3 + i], seed=i)
               for i in range(3)]
    eng.start()
    try:
        replies = [w.get(timeout=300) for w in waiters]
    finally:
        eng.stop()
    profiling.disable()
    assert not any(isinstance(r, Exception) for r in replies), replies
    assert tracer.resolve() == 0

    waits = tracer.spans("engine.queue_wait")
    assert len(waits) == 3 and len({r.trace_id for r in waits}) == 3
    assert all(r.parent_id is None for r in waits)
    (batch,) = tracer.spans("engine.batch")
    assert batch.attrs == {"rows": 3, "bucket": 4, "route": "fused"}
    children = [r.name for r in tracer.spans()
                if r.parent_id == batch.span_id]
    for name in ("engine.upload", "engine.readback", "engine.reply",
                 "ldm.encode", "ldm.style", "ldm.pack", "ldm.sample",
                 "ldm.decode", "audio.nnls", "audio.griffin_lim"):
        assert children.count(name) == 1, (name, children)
    assert all(r.device_ms is None for r in tracer.spans())

    after = eng.stats()
    assert before["dispatches_by_bucket"] == {}
    assert after["dispatches_by_bucket"] == {4: 1}
    assert after["rows_dispatched"] == before["rows_dispatched"] + 3
    assert before["queue_waits"] == 0 and after["queue_waits"] == 3
    assert after["queue_wait_s_total"] == pytest.approx(
        sum(r.end - r.start for r in waits))
    assert after["batches"] == 1 and after["padded_slots"] == 1

    # a direct call is a dispatch, but no request of it waited in the queue
    eng.transfer_batch(images[:1], images[3:4])
    direct = eng.stats()
    assert direct["dispatches_by_bucket"] == {2: 1, 4: 1}
    assert direct["rows_dispatched"] == after["rows_dispatched"] + 1
    assert direct["padded_slots"] == 2
    assert direct["queue_waits"] == 3
    assert direct["queue_wait_s_total"] == after["queue_wait_s_total"]


def test_the_ldm_step_opens_four_spans_in_order():
    cfg = default_config()
    cfg.train = dataclasses.replace(cfg.train, batch_size=4,
                                    compute_dtype="float32")
    cfg.model = dataclasses.replace(cfg.model, image_size=64)
    trainer = LDMTrainer(cfg, perceptual=False, device="cpu")
    state = trainer.init_state(0)
    rng = np.random.RandomState(2)
    content, style = (torch.tensor(rng.rand(4, 64, 64, 1).astype(np.float32))
                      for _ in range(2))
    tracer = profiling.enable()
    state, _ = trainer._step(state, content, style)
    profiling.disable()
    assert state.step == 1
    assert _names(tracer) == ["train.draws", "train.forward",
                              "train.backward", "train.optimizer"]
    assert all(r.parent_id is None for r in tracer.spans())
    starts = [r.start for r in tracer.spans()]
    assert starts == sorted(starts)


def test_the_device_loader_draws_one_span_a_batch(tmp_path):
    rng = np.random.RandomState(1)
    for label in ("a", "b"):
        (tmp_path / "imgs" / label).mkdir(parents=True)
        for i in range(3):
            (tmp_path / "imgs" / label / f"{i}.png").write_bytes(
                write_png_gray(rng.randint(0, 256, (128, 130)).astype(
                    np.uint8)))
    generate_pairings(tmp_path / "imgs", tmp_path / "pairs.csv",
                      num_pairs=10)
    build_pack(tmp_path / "imgs", tmp_path / "d.spk")
    loader = DevicePairLoader(DeviceResidentPairs(
        tmp_path / "d.spk", tmp_path / "pairs.csv", device="cpu"), 4,
        seed=5)
    tracer = profiling.enable()
    batches = list(loader)
    profiling.disable()
    draws = tracer.spans()
    assert len(batches) == 3
    assert [r.name for r in draws] == ["data.draw"] * 3
    assert all(r.parent_id is None for r in draws)
