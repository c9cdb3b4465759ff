"""The serving scheduler: ``paddle_tpu_torch.serving.ServingScheduler``
over the port's ``ContinuousBatchingEngine`` (CPU) against
``paddle_tpu.serving.ServingScheduler`` over the JAX engine.

Each scenario of the JAX package's scheduler tests runs through both
stacks on the same ``llama_tiny`` (2 layers) weights (JAX-made, carried
across through numpy), with the same submissions and a fake clock. The
two runs must agree on: tokens per handle and final states, engine
admission order, shed and cancel victims and reasons, the retry /
backoff / degrade sequence, deferred-submit promotion, the counters,
the clock-derived histograms' counts and sums, and the event log's
(kind, request) sequence. Scenarios with a real step watchdog compare
what does not depend on the wall clock."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu.observability.events as JEV
import paddle_tpu.profiler.record as JREC
import paddle_tpu.serving as JSV
import paddle_tpu_torch.observability.events as TEV
import paddle_tpu_torch.profiler.record as TREC
import paddle_tpu_torch.serving as TSV
from paddle_tpu.inference import decoding as JD
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import decoding as TD
from paddle_tpu_torch.models import llama as TL

STACKS = {
    "jax": SimpleNamespace(name="jax", L=JL, D=JD, SV=JSV, EV=JEV, REC=JREC,
                           dev={}),
    "torch": SimpleNamespace(name="torch", L=TL, D=TD, SV=TSV, EV=TEV,
                             REC=TREC, dev={"device": "cpu"}),
}
_WEIGHTS = {}


class FakeClock:
    """Deterministic scheduler clock; sleep() advances it."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt

    def advance(self, dt):
        self.t += dt


def _weights(st, seed):
    """The JAX package's ``init_stacked_params(seed)``; the port gets the
    same values through numpy."""
    if seed not in _WEIGHTS:
        cfg = JL.llama_tiny(num_hidden_layers=2)
        jp = JL.init_stacked_params(cfg, seed=seed)
        tcfg = TL.llama_tiny(num_hidden_layers=2)
        tp = TL.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                  tcfg, "cpu")
        _WEIGHTS[seed] = {"jax": (cfg, jp), "torch": (tcfg, tp)}
    return _WEIGHTS[seed][st.name]


def _engine(st, cfg, max_new, num_slots=2, chunk=2, seed=3,
            do_sample=False, num_pages=None):
    return st.D.ContinuousBatchingEngine(
        cfg, st.D.GenerationConfig(max_new_tokens=max_new,
                                   do_sample=do_sample, seed=seed),
        num_slots=num_slots, page_size=4, max_seq_len=32, chunk=chunk,
        num_pages=num_pages, **st.dev)


def _setup(st, max_new=5, num_slots=2, chunk=2, seed=3, do_sample=False,
           max_queue_depth=64, num_pages=None, fake_clock=True, tick=None,
           **sched_kw):
    """Engine and scheduler of one stack; ``tick`` advances the fake
    clock by that many seconds inside every engine step (so TTFT, ITL
    and e2e see the steps)."""
    cfg, params = _weights(st, seed)
    eng = _engine(st, cfg, max_new, num_slots, chunk, seed, do_sample,
                  num_pages)
    clock = FakeClock()
    if tick is not None:
        real_step = eng.step

        def ticking_step(p):
            clock.advance(tick)
            return real_step(p)
        eng.step = ticking_step
    kw = dict(clock=clock, sleep=clock.sleep) if fake_clock else {}
    sched = st.SV.ServingScheduler(
        eng, st.SV.SchedulerConfig(max_queue_depth=max_queue_depth,
                                   **sched_kw), **kw)
    return SimpleNamespace(st=st, cfg=cfg, params=params, eng=eng,
                           sched=sched, clock=clock)


def _prompts(n, rng_seed=0, lens=(3, 8), vocab=256):
    rng = np.random.RandomState(rng_seed)
    return [rng.randint(1, vocab, (int(rng.randint(lens[0], lens[1] + 1)),)
                        ).astype(np.int32) for _ in range(n)]


def _summary(env, handles, clock_hists=True, **extra):
    """What both stacks must agree on after a scenario."""
    m, eng = env.sched.metrics, env.eng
    admitted = sorted((h.engine_rid, i) for i, h in enumerate(handles)
                      if h.engine_rid is not None)
    out = dict(
        tokens=[list(h.stream.tokens) for h in handles],
        states=[h.state for h in handles],
        reasons=[h.stream.finish_reason for h in handles],
        admission=[i for _, i in admitted],
        shed=dict(m.shed), free_pages=eng.mgr.num_free_pages,
        usable_pages=eng.mgr.usable_pages, pending=env.sched.pending,
        degraded=env.sched.degraded, **extra)
    if clock_hists:
        out["counters"] = dict(m.counters)
        out["hists"] = {k: (h.count, h.sum, list(h.bucket_counts))
                        for k, h in m.histograms.items()}
    else:
        out["_real_clock"] = True
    return out


# ---------------------------------------------------------------------------
# scenarios (the JAX package's tests/test_serving.py, l.79-597)
# ---------------------------------------------------------------------------

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def priority_fifo_within_class(st):
    env = _setup(st, num_slots=1, tick=0.007)
    hs = [env.sched.submit(p, priority=pr)
          for p, pr in zip(_prompts(5, 1), (2, 0, 1, 0, 2))]
    env.sched.run(env.params, max_steps=200)
    out = _summary(env, hs)
    assert out["admission"] == [1, 3, 2, 0, 4]
    return out


@scenario
def outputs_match_engine_serve(st):
    env = _setup(st, max_new=4, tick=0.013)
    ps = _prompts(4, 2)
    hs = [env.sched.submit(p) for p in ps]
    env.sched.run(env.params, max_steps=200)
    oracle = _engine(st, env.cfg, 4).serve(env.params, ps)
    assert [h.stream.result() for h in hs] == oracle
    return _summary(env, hs)


@scenario
def per_request_max_new_tokens(st):
    env = _setup(st, max_new=5)
    ps = _prompts(2, 3)
    hs = [env.sched.submit(ps[0], max_new_tokens=2),
          env.sched.submit(ps[1])]
    env.sched.run(env.params, max_steps=200)
    assert [len(h.stream.tokens) for h in hs] == [2, 5]
    return _summary(env, hs)


@scenario
def queue_overflow_sheds_worst(st):
    env = _setup(st, max_queue_depth=3)
    ps = _prompts(5, 4)
    sched = env.sched
    hs = [sched.submit(ps[0], priority=0, deadline_ms=100),
          sched.submit(ps[1], priority=1, deadline_ms=50),
          sched.submit(ps[2], priority=1, deadline_ms=500),
          sched.submit(ps[3], priority=1, deadline_ms=200),
          sched.submit(ps[4], priority=1)]
    shed_at_submit = [h.state for h in hs]
    with pytest.raises(st.SV.ServingError) as ei:
        hs[2].stream.result()
    sched.run(env.params, max_steps=200)
    return _summary(env, hs, shed_at_submit=shed_at_submit,
                    code=ei.value.code)


@scenario
def deadline_expiry_sheds_queued(st):
    env = _setup(st, num_slots=1)
    ps = _prompts(2, 5)
    hs = [env.sched.submit(ps[0], priority=0),
          env.sched.submit(ps[1], priority=1, deadline_ms=50)]
    env.clock.advance(0.2)
    env.sched.run(env.params, max_steps=200)
    return _summary(env, hs)


@scenario
def mid_decode_cancel_frees_slot(st):
    env = _setup(st, max_new=8)
    free0 = env.eng.mgr.num_free_pages
    hs = [env.sched.submit(p) for p in _prompts(2, 6)]
    steps = 0
    for steps in range(1, 11):
        env.sched.step(env.params)
        if hs[0].stream.tokens:
            break
    cancelled = env.sched.cancel(hs[0].rid)
    free_slots = env.eng.num_free_slots
    again = env.sched.cancel(hs[0].rid)
    env.sched.run(env.params, max_steps=200)
    assert env.eng.mgr.num_free_pages == free0
    return _summary(env, hs, steps=steps, cancelled=cancelled,
                    free_slots=free_slots, again=again)


@scenario
def on_token_cancels_own_request(st):
    env = _setup(st, max_new=6)
    box = {}
    hs = [env.sched.submit(_prompts(2, 16)[0],
                           on_token=lambda t: env.sched.cancel(box["rid"]))]
    box["rid"] = hs[0].rid
    hs.append(env.sched.submit(_prompts(2, 16)[1]))
    env.sched.run(env.params, max_steps=200)
    assert len(hs[0].stream.tokens) == 1
    env.eng.mgr.check_conservation()
    return _summary(env, hs)


@scenario
def finished_requests_evicted(st):
    env = _setup(st)
    hs = [env.sched.submit(p) for p in _prompts(3, 17)]
    env.sched.run(env.params, max_steps=200)
    assert env.sched._requests == {}
    return _summary(env, hs, again=env.sched.cancel(hs[0].rid))


@scenario
def cancel_queued_never_reaches_engine(st):
    env = _setup(st, num_slots=1)
    hs = [env.sched.submit(p) for p in _prompts(2, 7)]
    cancelled = env.sched.cancel(hs[1].rid)
    env.sched.run(env.params, max_steps=200)
    return _summary(env, hs, cancelled=cancelled)


@scenario
def tokens_stream_at_chunk_cadence(st):
    env = _setup(st, max_new=6, num_slots=1, tick=0.005)
    seen = []
    h = env.sched.submit(_prompts(1, 8)[0], on_token=seen.append)
    growth = []
    while env.sched.pending:
        env.sched.step(env.params)
        growth.append(len(h.stream.drain()))
    assert seen == h.stream.result() and sum(growth) == 6
    return _summary(env, [h], growth=growth)


@scenario
def blocking_iterator_consumer_thread(st):
    env = _setup(st, max_new=4, num_slots=1)
    h = env.sched.submit(_prompts(1, 9)[0])
    got = []
    t = threading.Thread(target=lambda: got.extend(h.stream))
    t.start()
    env.sched.run(env.params, max_steps=200)
    t.join(timeout=10)
    assert not t.is_alive()
    return _summary(env, [h], consumed=got)


@scenario
def infeasible_rejected_at_submit(st):
    env = _setup(st)
    errors = []
    with pytest.raises(ValueError, match="max_seq_len") as e1:
        env.sched.submit(np.ones(40, np.int32))
    errors.append(str(e1.value))
    small = _engine(st, env.cfg, 5, num_pages=2)      # 1 usable page
    sched2 = st.SV.ServingScheduler(small)
    with pytest.raises(ValueError, match="KV pages") as e2:
        sched2.submit(np.ones(8, np.int32))
    errors.append(str(e2.value))
    return _summary(env, [], errors=errors, pending2=sched2.pending)


@scenario
def page_pressure_no_priority_inversion(st):
    env = _setup(st, max_new=4, num_pages=3)     # 2 usable pages
    rng = np.random.RandomState(15)

    def prompt():
        return rng.randint(1, 256, (4,)).astype(np.int32)

    hs = [env.sched.submit(prompt(), priority=1)]
    env.sched.step(env.params)
    hs += [env.sched.submit(prompt(), priority=1),
           env.sched.submit(prompt(), priority=0)]
    while env.sched.pending:
        env.sched.step(env.params)
        assert env.eng.num_queued == 0
    assert hs[2].engine_rid < hs[1].engine_rid
    return _summary(env, hs)


@scenario
def injected_failure_retried_with_backoff(st):
    env = _setup(st, max_new=4, retry_backoff_s=0.05,
                 retry_backoff_multiplier=2.0, max_step_retries=3)
    real_step, fails, calls = env.eng.step, {"n": 2}, []

    def flaky_step(p):
        calls.append(env.clock())
        if fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("injected device fault")
        return real_step(p)

    env.eng.step = flaky_step
    h = env.sched.submit(_prompts(1, 10)[0])
    env.sched.run(env.params, max_steps=200)
    return _summary(env, [h], calls=calls)


@scenario
def repeated_failure_degrades(st):
    env = _setup(st, num_slots=1, max_step_retries=2, retry_backoff_s=0.01)
    free0 = env.eng.mgr.num_free_pages

    def always_fail(p):
        raise RuntimeError("persistent device fault")

    env.eng.step = always_fail
    ps = _prompts(3, 11)
    hs = [env.sched.submit(p) for p in ps]
    env.sched.run(env.params, max_steps=200)
    codes = []
    for h in hs:
        with pytest.raises(st.SV.ServingError) as ei:
            h.stream.result()
        codes.append(ei.value.code)
    with pytest.raises(st.SV.ServingError):
        env.sched.submit(ps[0])
    assert env.eng.mgr.num_free_pages == free0
    return _summary(env, hs, codes=codes)


@scenario
def step_timeout_counts_as_failure(st):
    env = _setup(st, fake_clock=False, step_timeout_s=0.05,
                 max_step_retries=1, retry_backoff_s=0.01)

    def hung_step(p):
        time.sleep(0.5)

    env.eng.step = hung_step
    h = env.sched.submit(_prompts(1, 12)[0])
    env.sched.run(env.params, max_steps=200)
    return _summary(env, [h], clock_hists=False,
                    failures=env.sched.metrics.counters[
                        "step_failures_total"])


@scenario
def timed_out_step_never_concurrent(st):
    # retries enough that a step slowed by a loaded box never exhausts
    # them: each retry waits one more timeout on the straggler
    env = _setup(st, max_new=4, fake_clock=False, step_timeout_s=0.05,
                 max_step_retries=50, retry_backoff_s=0.01)
    env.eng.serve(env.params, [np.arange(1, 5, dtype=np.int32)])  # warm
    real_step, lock = env.eng.step, threading.Lock()
    state = {"active": 0, "max_active": 0, "calls": 0}

    def slow_first_step(p):
        with lock:
            state["active"] += 1
            state["max_active"] = max(state["max_active"], state["active"])
            state["calls"] += 1
            first = state["calls"] == 1
        try:
            if first:
                time.sleep(0.2)
            return real_step(p)
        finally:
            with lock:
                state["active"] -= 1

    env.eng.step = slow_first_step
    h = env.sched.submit(np.arange(1, 5, dtype=np.int32))
    env.sched.run(env.params, max_steps=200)
    return _summary(env, [h], clock_hists=False,
                    max_active=state["max_active"],
                    failed=env.sched.metrics.counters[
                        "step_failures_total"] >= 1)


@scenario
def sampled_trace_deterministic(st):
    runs = []
    for _ in range(2):
        env = _setup(st, num_slots=2, do_sample=True, seed=7)
        hs = [env.sched.submit(p, priority=pr) for p, pr in
              zip(_prompts(6, 13), (1, 0, 2, 0, 1, 2))]
        env.sched.run(env.params, max_steps=300)
        runs.append(_summary(env, hs))
    assert runs[0] == runs[1]
    return runs[0]


@scenario
def deferred_submit_admits_after_backoff(st):
    env = _setup(st)
    h = env.sched.submit(_prompts(1, 20)[0], defer_s=1.0)
    pending0 = env.sched.pending
    env.sched.step(env.params)
    parked = (h.state, h.engine_rid, env.sched.statusz()["backoff"])
    env.clock.advance(1.5)
    env.sched.run(env.params, max_steps=200)
    return _summary(env, [h], pending0=pending0, parked=parked)


@scenario
def run_waits_out_backoff(st):
    env = _setup(st)
    h = env.sched.submit(_prompts(1, 26)[0], defer_s=2.0)
    env.sched.run(env.params, max_steps=60)
    return _summary(env, [h], t=env.clock())


@scenario
def cancel_in_backoff_idempotent(st):
    env = _setup(st)
    h = env.sched.submit(_prompts(1, 21)[0], defer_s=0.5)
    cancels = [env.sched.cancel(h.rid), env.sched.cancel(h.rid)]
    env.clock.advance(2.0)
    for _ in range(3):
        env.sched.step(env.params)
    assert not env.eng.num_queued and env.eng.num_free_slots == 2
    return _summary(env, [h], cancels=cancels)


@scenario
def promoted_backoff_exempt_from_shed(st):
    env = _setup(st, num_slots=1, max_queue_depth=2)
    ps = _prompts(5, 24)
    sched = env.sched
    hs = [sched.submit(ps[0])]
    sched.step(env.params)
    hs += [sched.submit(ps[1]), sched.submit(ps[2]),
           sched.submit(ps[3], defer_s=0.1)]
    env.clock.advance(0.5)
    sched.step(env.params)
    after_promotion = [h.state for h in hs]
    sched.run(env.params, max_steps=300)
    return _summary(env, hs, after_promotion=after_promotion)


@scenario
def deferred_deadline_expires_in_backoff(st):
    env = _setup(st)
    h = env.sched.submit(_prompts(1, 22)[0], deadline_ms=100, defer_s=10.0)
    env.clock.advance(0.5)
    env.sched.step(env.params)
    return _summary(env, [h])


@scenario
def lapsed_deferred_never_displaces(st):
    env = _setup(st, num_slots=1, max_queue_depth=2)
    ps = _prompts(4, 25)
    sched = env.sched
    hs = [sched.submit(ps[0])]
    sched.step(env.params)
    hs += [sched.submit(ps[1]), sched.submit(ps[2]),
           sched.submit(ps[3], deadline_ms=50, defer_s=0.1)]
    env.clock.advance(0.5)
    sched.step(env.params)
    after = [h.state for h in hs]
    sched.run(env.params, max_steps=300)
    return _summary(env, hs, after=after)


@scenario
def fatal_engine_death_closes_streams(st):
    class FatalDeath(BaseException):
        pass

    env = _setup(st)

    def dying_step(p):
        raise FatalDeath("runtime died")

    env.eng.step = dying_step
    hs = [env.sched.submit(p) for p in _prompts(2, 23)]
    got = []
    t = threading.Thread(target=lambda: got.extend(hs[0].stream))
    t.start()
    with pytest.raises(FatalDeath):
        env.sched.step(env.params)
    t.join(timeout=10)
    assert not t.is_alive()
    return _summary(env, hs, consumed=got)


@scenario
def e2e_mixed_priorities_with_metrics(st):
    env = _setup(st, num_slots=4, max_queue_depth=32, max_step_retries=2,
                 retry_backoff_s=0.001, tick=0.009)
    real_step, armed = env.eng.step, {"on": True}

    def flaky_step(p):
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected transient fault")
        return real_step(p)

    env.eng.step = flaky_step
    rec = st.REC.host_recorder
    rec.enabled = True
    rec.clear()
    try:
        rng = np.random.RandomState(14)
        hs = []
        for i in range(16):
            prompt = rng.randint(1, 256, (int(rng.randint(3, 9)),)
                                 ).astype(np.int32)
            hs.append(env.sched.submit(prompt, priority=i % 3))
        hs.append(env.sched.submit(
            rng.randint(1, 256, (4,)).astype(np.int32), priority=2,
            deadline_ms=1e-3))
        env.clock.advance(0.01)
        for _ in range(20):
            env.sched.step(env.params)
            if any(h.stream.tokens for h in hs):
                break
        cancelled = env.sched.cancel(hs[5].rid)
        env.sched.run(env.params, max_steps=500)
    finally:
        rec.enabled = False
    names = sorted({s.name for s in rec.drain()})
    assert "paddle_serving.step_retry" in names
    text = env.sched.metrics.to_prometheus_text()
    return _summary(env, hs, cancelled=cancelled, span_names=names,
                    prometheus=text)


@scenario
def slo_breach_sheds_then_recovers(st):
    """Slow steps breach the TTFT objective: the breach sheds queued
    work (reason ``slo``); fast steps recover it."""
    env = _setup(st, max_new=4, max_queue_depth=16)
    monitor = env.sched.make_slo_monitor(
        ttft_p95_ms=200, max_shed_ratio=None, fast_window_s=60,
        slow_window_s=600, burn_threshold=5)
    slow, real_step = [True], env.eng.step

    def injected(p):
        env.clock.advance(1.0 if slow[0] else 0.001)
        return real_step(p)

    env.eng.step = injected
    hs = [env.sched.submit(np.array([3 + i, 5, 7], np.int32))
          for i in range(10)]
    while env.sched.pending:
        env.sched.step(env.params)
        env.clock.advance(0.5)
    breached = monitor.breached("ttft")
    slow[0] = False
    for i in range(8):
        hs.append(env.sched.submit(np.array([9 + i % 4, 5, 7], np.int32)))
        while env.sched.pending:
            env.sched.step(env.params)
            env.clock.advance(10.0)
    assert breached and not monitor.breached()
    assert env.sched.metrics.shed.get("slo", 0) >= 1
    return _summary(env, hs, slo=monitor.states())


# ---------------------------------------------------------------------------
# the parity test over every scenario
# ---------------------------------------------------------------------------

def _traced(st, fn, monkeypatch):
    events = []

    def emit(kind, **fields):
        if kind != "recompile":
            events.append((kind, fields.get("request_id")))

    monkeypatch.setattr(st.EV.event_log, "emit", emit)
    out = fn(st)
    # on the real clock how many retries a slow step takes is timing:
    # compare which events occurred, not how often
    out["events"] = (sorted(set(events), key=repr)
                     if out.pop("_real_clock", False) else events)
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax_stack(name, monkeypatch):
    want = _traced(STACKS["jax"], SCENARIOS[name], monkeypatch)
    got = _traced(STACKS["torch"], SCENARIOS[name], monkeypatch)
    assert got == want


def test_stream_producer_death_unblocks_consumer():
    """A blocking consumer of a stream whose producer dies without
    closing it gets the terminal ``producer_dead`` error."""
    alive = [True]
    stream = TSV.TokenStream(0)
    stream.attach_producer(lambda: alive[0], poll_s=0.01)
    got = []
    t = threading.Thread(target=lambda: got.append(stream.get()))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()
    alive[0] = False
    t.join(timeout=10)
    assert not t.is_alive() and got == [None]
    assert stream.finished and stream.finish_reason == "failed"
    with pytest.raises(TSV.ServingError) as ei:
        stream.result()
    assert ei.value.code == "producer_dead"


def test_signal_bus_waits_for_its_port():
    env = _setup(STACKS["torch"])
    with pytest.raises(NotImplementedError, match="signals"):
        env.sched.attach_signal_bus()


def test_scheduler_runs_the_engine_on_the_card_by_default():
    """No fallback: an engine built without ``device`` is the card's; with
    no card it raises before a scheduler can wrap it."""
    import torch
    cfg, _ = _weights(STACKS["torch"], 3)

    def build():
        return TD.ContinuousBatchingEngine(cfg, TD.GenerationConfig(),
                                           num_slots=1, page_size=4,
                                           max_seq_len=32)
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
