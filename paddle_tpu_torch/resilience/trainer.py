"""``ResilientTrainer`` — counterpart of ``paddle_tpu/resilience/trainer.py``
(l.52-414): the training loop that owns failure recovery. It wraps a
:class:`~paddle_tpu_torch.distributed.checkpoint.TrainState` and a user
step function ``step_fn(step) -> loss`` and keeps going through:

* **auto-resume**: on start, restore the newest intact durable
  checkpoint (corrupt ones skipped by their checksums);
* **preemption**: SIGTERM (or an injected preemption, sent as a real
  SIGTERM when the handler is installed: on the main thread only)
  finishes the current step, flushes a durable save and raises
  :class:`Preempted` so a supervisor can reschedule;
* **NaN/Inf loss**: reload the last good checkpoint and replay (faults
  are one-shot, so the replay is clean); a step that keeps giving NaN
  past the budget is skipped;
* **transient step failures**: retries with bounded exponential
  backoff, then a structured :class:`TrainingAborted`.

Checkpoints round-trip bit for bit and a replay re-runs the same step
function at the same step indices, so a chaos run ends on the state of
an uninterrupted run, byte for byte. The step's loss is read as
``float(loss)`` (a Tensor, a torch tensor or a number): that read is the
step's fence for the step timer. Goodput, straggler, step-timer, flight
and trace taps are the reference's.
"""

from __future__ import annotations

import logging
import math
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Set

import torch

from ..observability.events import emit_event
from ..observability.flight import flight_recorder
from ..observability.goodput import GoodputTracker, StragglerDetector
from ..observability.memory import (memory_armed, memory_ledger,
                                    pytree_nbytes)
from ..observability.step_timer import StepTimer
from ..observability.trace import trace_context
from .durable import (async_save_checkpoint, checkpoint_path, latest_step,
                      restore_train_state, save_checkpoint)
from .faults import ChaosError, FaultInjector
from .metrics import ResilienceMetrics

logger = logging.getLogger("paddle_tpu_torch.resilience")


class Preempted(RuntimeError):
    """Raised after a preemption was handled cleanly: the final checkpoint
    is durable at ``checkpoint``; re-running the trainer resumes there."""

    def __init__(self, step: int, checkpoint: Optional[str]):
        super().__init__(
            f"preempted at step {step}; state flushed to {checkpoint!r}")
        self.step = step
        self.checkpoint = checkpoint


class TrainingAborted(RuntimeError):
    """Training gave up, with a structured reason."""

    def __init__(self, reason: str, step: int, **info: Any):
        super().__init__(f"training aborted at step {step}: {reason} "
                         f"{info or ''}".rstrip())
        self.reason = reason
        self.step = step
        self.info = info


@dataclass
class ResilienceConfig:
    checkpoint_dir: str
    save_interval: int = 100         # steps between durable saves
    keep: int = 3                    # retention: newest N checkpoints
    async_save: bool = True          # overlap shard IO with training
    max_step_retries: int = 3        # per-step exception retries
    retry_backoff: float = 0.05      # seconds; doubles per attempt
    retry_backoff_cap: float = 2.0
    max_nan_rollbacks: int = 2       # per-step; beyond it the step is skipped
    install_signal_handlers: bool = True
    fault_injector: Optional[FaultInjector] = None
    chaos_seed: Optional[int] = None  # build a seeded injector at run()
                                      # scaled to the actual run length
    # step-telemetry knobs (observability.StepTimer): tokens processed per
    # step for tokens/sec, model FLOPs per step + chip peak for the MFU
    # estimate; all optional (timer still reports host/device breakdown)
    tokens_per_step: int = 0
    flops_per_step: Optional[float] = None
    peak_flops_per_s: Optional[float] = None
    # straggler detection over per-step wall time (rolling MAD z-score;
    # flags count into paddle_stragglers_total and the event log)
    straggler_window: int = 32
    straggler_z: float = 4.0


class ResilientTrainer:
    def __init__(self, state, config: ResilienceConfig,
                 metrics: Optional[ResilienceMetrics] = None):
        self.state = state
        self.cfg = config
        self.metrics = metrics or ResilienceMetrics()
        self.step_timer = StepTimer(flops_per_step=config.flops_per_step,
                                    peak_flops_per_s=config.peak_flops_per_s)
        self.goodput = GoodputTracker()
        self.stragglers = StragglerDetector(window=config.straggler_window,
                                            z_threshold=config.straggler_z)
        self._goodput_hw = -1          # highest step already run in-process
        self._wasted_s = 0.0           # retry time inside the last step
        self.last_loss: Optional[float] = None
        self.resumed_from: Optional[int] = None
        self._pending = None           # in-flight AsyncSaveFuture
        self._pending_step: Optional[int] = None
        self._preempt_requested = False
        self._prev_handler = None
        self._handlers_installed = False
        self._nan_counts: Dict[int, int] = {}
        self._skip_steps: Set[int] = set()

    # -- checkpointing ------------------------------------------------------

    def resume(self) -> Optional[int]:
        """Restore the newest intact checkpoint into ``self.state``;
        returns the restored global step (None if nothing loadable)."""
        self._harvest(block=True)
        step = restore_train_state(self.state, self.cfg.checkpoint_dir,
                                   self.metrics)
        if step is not None:
            logger.info("auto-resume: restored step %d from %s", step,
                        self.cfg.checkpoint_dir)
        self.resumed_from = step
        return step

    def save(self, block: bool = False) -> Optional[str]:
        """Durable save at the current global step (async unless ``block``
        or the config says sync). Returns the committed path for a blocking
        save (None when it failed — failure is logged + counted; an interval
        save failing degrades durability but must not kill training).

        The time the TRAINING LOOP is blocked here — waiting out the
        previous async save, copying the state dict, the whole sync
        write — is goodput's ``checkpoint_stall`` bucket (overlapped
        async IO is free by construction)."""
        t_stall = time.perf_counter()
        try:
            self._harvest(block=True)  # serialize after the last save
            step = self.state.global_step
            sd = self.state.state_dict()
            if memory_armed[0]:
                # HBM ledger: the training side's resident state (params
                # + optimizer accumulators), dtype-aware, refreshed on
                # the save cadence — the "optimizer" class next to the
                # serving pool's kv_* classes
                memory_ledger.note_class("optimizer", pytree_nbytes(sd))
            if self.cfg.async_save and not block:
                self._pending = async_save_checkpoint(
                    sd, self.cfg.checkpoint_dir, step, keep=self.cfg.keep,
                    fault_injector=self.cfg.fault_injector)
                self._pending_step = step
                return None
            t0 = time.perf_counter()
            try:
                path = save_checkpoint(
                    sd, self.cfg.checkpoint_dir, step, keep=self.cfg.keep,
                    fault_injector=self.cfg.fault_injector)
            except Exception as e:
                self.metrics.inc("save_failures")
                emit_event("save_failure", step=step, error=repr(e))
                logger.warning("checkpoint save at step %d failed: %s",
                               step, e)
                return None
            self.metrics.observe_save_ms((time.perf_counter() - t0) * 1e3)
            return path
        finally:
            self.goodput.note("checkpoint_stall",
                              time.perf_counter() - t_stall)

    def _harvest(self, block: bool) -> None:
        """Collect the outcome of the in-flight async save, if any. A
        failed save degrades durability (logged + counted) but must not
        kill training — the next interval save re-establishes it."""
        fut = self._pending
        if fut is None:
            return
        if not block and not fut.done():
            return
        try:
            fut.result()
            self.metrics.observe_save_ms(
                getattr(fut, "elapsed_s", 0.0) * 1e3)
        except Exception as e:
            self.metrics.inc("save_failures")
            emit_event("save_failure", step=self._pending_step,
                       error=repr(e), asynchronous=True)
            logger.warning("async checkpoint save at step %s failed: %s",
                           self._pending_step, e)
        self._pending = None
        self._pending_step = None

    # -- signals / preemption -----------------------------------------------

    def _on_sigterm(self, signum, frame):  # noqa: ARG002 (signal signature)
        self._preempt_requested = True

    def _install_handlers(self) -> None:
        if not self.cfg.install_signal_handlers:
            return
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            self._prev_handler = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
            self._handlers_installed = True
        except ValueError:  # non-main interpreter thread
            self._handlers_installed = False

    def _restore_handlers(self) -> None:
        if self._handlers_installed:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._handlers_installed = False

    def _simulate_preemption(self) -> None:
        self.metrics.inc("preemptions")
        if self._handlers_installed:
            os.kill(os.getpid(), signal.SIGTERM)  # the real signal path
        else:
            self._preempt_requested = True

    def _preempt_exit(self) -> "Preempted":
        """Flush a final durable checkpoint and build the Preempted error.
        If the flush itself fails, Preempted must NOT advertise a path that
        was never written — it points at the newest intact checkpoint
        instead (the one a rerun will actually resume from)."""
        self._harvest(block=True)
        path = self.save(block=True)
        self.metrics.inc("preempt_flushes")
        emit_event("preempt_flush", step=self.state.global_step,
                   checkpoint=path)
        if path is None:
            intact = latest_step(self.cfg.checkpoint_dir)
            path = (checkpoint_path(self.cfg.checkpoint_dir, intact)
                    if intact is not None else None)
        return Preempted(self.state.global_step, path)

    # -- failure handling ----------------------------------------------------

    def _step_with_retry(self, step_fn: Callable[[int], Any], step: int):
        delay = self.cfg.retry_backoff
        attempt = 0
        wasted = 0.0          # failed attempts + backoff -> goodput retry
        self._wasted_s = 0.0
        while True:
            t_attempt = time.perf_counter()
            try:
                fi = self.cfg.fault_injector
                if fi is not None and fi.fire("step_error", step):
                    raise ChaosError(f"injected step failure at step {step}")
                result = step_fn(step)
                self._wasted_s = wasted
                return result
            except (Preempted, TrainingAborted):
                raise
            except Exception as e:
                if attempt >= self.cfg.max_step_retries:
                    raise TrainingAborted(
                        "step_failed_after_retries", step,
                        retries=attempt, error=repr(e)) from e
                attempt += 1
                self.metrics.inc("step_retries")
                emit_event("step_retry", step=step, attempt=attempt,
                           error=repr(e), backoff_s=delay)
                logger.warning("step %d failed (%s); retry %d/%d in %.2fs",
                               step, e, attempt, self.cfg.max_step_retries,
                               delay)
                time.sleep(delay)
                waste = time.perf_counter() - t_attempt
                wasted += waste
                self.goodput.note("retry", waste)
                delay = min(delay * 2, self.cfg.retry_backoff_cap)

    def _rollback(self, offending_step: int, reason: str) -> None:
        """Reload the last good checkpoint and let the loop replay forward.
        One-shot faults will not re-fire during the replay, so a transient
        NaN converges back onto the uninterrupted trajectory."""
        t0 = time.perf_counter()
        # snapshot the moments leading into the rollback while they are
        # still in the flight ring (armed + dump_dir only, never raises)
        flight_recorder.auto_dump("nan_rollback")
        self._harvest(block=True)
        self.metrics.inc("nan_rollbacks")
        restored = restore_train_state(self.state, self.cfg.checkpoint_dir,
                                       self.metrics)
        if restored is None:
            raise TrainingAborted("no_intact_checkpoint", offending_step,
                                  detail=reason)
        emit_event("rollback", reason=reason, step=offending_step,
                   restored_step=restored)
        logger.warning("rolled back to step %d after %s at step %d",
                       restored, reason, offending_step)
        self.goodput.note("rollback_replay", time.perf_counter() - t0)

    def _note_nan(self, step: int) -> None:
        n = self._nan_counts.get(step, 0) + 1
        self._nan_counts[step] = n
        if n > self.cfg.max_nan_rollbacks:
            # genuinely divergent, not transient: skip it on replay
            self._skip_steps.add(step)
            self.metrics.inc("steps_skipped")
            emit_event("step_skipped", step=step, nan_count=n)
            logger.error("step %d produced NaN/Inf %d times; skipping it",
                         step, n)

    # -- the loop ------------------------------------------------------------

    def run(self, step_fn: Callable[[int], Any], num_steps: int,
            resume: bool = True) -> Dict[str, Any]:
        """Drive ``step_fn(step) -> loss`` until ``global_step`` reaches
        ``num_steps``, surviving crashes/preemptions/corruption along the
        way. Raises :class:`Preempted` after a clean preemption flush and
        :class:`TrainingAborted` when the failure budget is exhausted."""
        cfg = self.cfg
        t_run = time.perf_counter()
        # fresh accounting per run: a reused trainer must not bill a
        # previous run's buckets against this run's wall clock
        self.goodput = GoodputTracker()
        self.stragglers = StragglerDetector(window=cfg.straggler_window,
                                            z_threshold=cfg.straggler_z)
        self._goodput_hw = -1
        self._wasted_s = 0.0
        if cfg.fault_injector is None and cfg.chaos_seed is not None:
            # built here, where the real run length is known — seeding over
            # a huge fixed step space would schedule faults that never fire
            cfg.fault_injector = FaultInjector.seeded(cfg.chaos_seed,
                                                      num_steps=num_steps)
        if resume:
            t0 = time.perf_counter()
            self.resume()
            self.goodput.note("restart", time.perf_counter() - t0)
        if latest_step(cfg.checkpoint_dir) is None:
            # seed checkpoint: the rollback/preemption target must exist
            # before the first interval save
            self.save(block=True)
        self._install_handlers()
        try:
            while self.state.global_step < num_steps:
                step = self.state.global_step
                if self._preempt_requested:
                    raise self._preempt_exit()
                fi = cfg.fault_injector
                if fi is not None and fi.fire("preempt", step):
                    self._simulate_preemption()
                if step in self._skip_steps:
                    self.state.step()
                    continue
                with trace_context(step=step):
                    self.step_timer.begin()
                    loss = self._step_with_retry(step_fn, step)
                    lv = loss._value if hasattr(loss, "_value") else loss
                    if isinstance(lv, torch.Tensor):
                        lv = lv.detach()
                    self.step_timer.host_done()   # dispatch done; the
                    lf = float(lv)                # float() is the fence
                    step_s = self.step_timer.end(
                        tokens=cfg.tokens_per_step) or 0.0
                # goodput: the successful attempt's time (retries/backoff
                # were booked inside _step_with_retry) is productive only
                # when the step is NEW progress producing a finite loss;
                # a re-execution below the high-water mark is replay, a
                # NaN attempt is wasted work charged to the rollback
                useful_s = max(0.0, step_s - self._wasted_s)
                if not math.isfinite(lf):
                    self.goodput.note("rollback_replay", useful_s)
                    self._note_nan(step)
                    self._rollback(step, "nan_loss")
                    continue
                self.goodput.note(
                    "rollback_replay" if step <= self._goodput_hw
                    else "productive", useful_s)
                self._goodput_hw = max(self._goodput_hw, step)
                # judge only the successful attempt: retry/backoff time is
                # already counted in step_retries_total, and letting it in
                # would both misflag the step and pollute the MAD window
                z = self.stragglers.observe(useful_s, source="train_step")
                if z > self.stragglers.z_threshold:
                    emit_event("straggler", step=step,
                               step_ms=round(useful_s * 1e3, 3),
                               z=round(z, 2))
                self.last_loss = lf
                self.state.step()
                gs = self.state.global_step
                if cfg.save_interval and gs % cfg.save_interval == 0 \
                        and gs < num_steps:
                    self.save()
                if self._preempt_requested:
                    raise self._preempt_exit()
            # final state is always durable: a failed flush retries once
            # (a transient/injected fault is consumed) then aborts loudly
            # rather than reporting completion without a durable result
            if self.save(block=True) is None and self.save(block=True) is None:
                raise TrainingAborted("final_save_failed",
                                      self.state.global_step)
        finally:
            self._restore_handlers()
            self._harvest(block=True)
        return {"resumed_from": self.resumed_from,
                "end_step": self.state.global_step,
                "last_loss": self.last_loss,
                "skipped_steps": sorted(self._skip_steps),
                "metrics": self.metrics.summary(),
                "step_timer": self.step_timer.summary(),
                "goodput": self.goodput.finalize(
                    time.perf_counter() - t_run),
                "stragglers": self.stragglers.flagged}
