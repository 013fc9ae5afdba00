"""The crash-resilient run supervisor: retry a chunk's dispatch from device
snapshots (port of the JAX package's `core/supervisor.py`; the memory and
wall-clock hooks of its observatories are left out).

  RUNNING --dispatch ok--> RUNNING (a snapshot every
                                    `snapshot_every_chunks` chunks, and
                                    with a checkpoint path an on-disk
                                    checkpoint of it)
  RUNNING --dispatch raises--> BACKOFF (sleep base * 2^attempt)
  BACKOFF --> RESTORE (a fresh copy of the last good snapshot; its digest
              signature is checked against the one recorded when it was
              taken, so a state that silently changed is never replayed)
  RESTORE --> RUNNING (the deterministic engine replays the lost chunks
              bit for bit)
  after `max_retries` failures of one chunk --> ABORT (SupervisorAbort);
  the driver keeps the last good state and still writes its report.

The kernels update the state in place on CUDA, so a failed dispatch may
have changed its input: the supervisor never reuses it and always replays
from a copy of the snapshot (`core/checkpoint.py` deep-copies every
tensor). Because the engine is deterministic, a retried run's final digest
is the uninterrupted run's.

On-disk checkpoints are written atomically (a temporary file, then
`os.replace`), so a kill in the middle of a write never leaves a truncated
file for the resume. With the environment variable
`SHADOW_TPU_TORCH_TEST_KILL_AT_CHECKPOINT=N` the process kills itself with
SIGKILL right after its N-th checkpoint lands: the hard crash the resume
path is tested against.
"""

from __future__ import annotations

import os
import signal
import time

import numpy as np

from shadow_tpu_torch.core.checkpoint import restore_snapshot, snapshot_state
from shadow_tpu_torch.core.integrity import IntegrityAbort
from shadow_tpu_torch.core.pressure import PressureAbort


class SupervisorAbort(RuntimeError):
    """Bounded retries exhausted (or a restored state failed its digest
    cross-check): the run cannot make progress. The driver still owns the
    last good state and writes the report of the completed prefix."""


def state_digest_sig(state) -> tuple[int, ...]:
    """Cheap signature of a SimState: (rounds, XOR of the per-host event
    digests), plus the XOR of the second digest on integrity-sentinel
    states (compare signatures whole, do not unpack them). Recorded at
    snapshot time and re-checked at restore time."""
    digest = int(np.bitwise_xor.reduce(state.stats.digest.cpu().numpy().reshape(-1)))
    rounds = int(state.stats.rounds.cpu().numpy().sum())
    d2 = getattr(state.stats, "digest2", None)
    if d2 is None:
        return rounds, digest
    return rounds, digest, int(np.bitwise_xor.reduce(d2.cpu().numpy().reshape(-1)))


class ChunkSupervisor:
    """Wraps a driver's chunk dispatch in snapshot, retry and abort
    handling: a failed chunk replays every chunk since the last snapshot
    (deterministic, so bit for bit). `syncs` counts the device-to-host
    reads of the digest signatures."""

    def __init__(
        self,
        *,
        snapshot_every_chunks: int = 1,
        max_retries: int = 3,
        backoff_base_s: float = 0.05,
        checkpoint_path: str | None = None,
        save_fn=None,
        log=None,
    ):
        self.checkpoint_path = checkpoint_path
        self._save_fn = save_fn  # (path, state) -> the file written
        self.snapshot_every = max(int(snapshot_every_chunks), 1)
        self.max_retries = int(max_retries)
        # clamp: a negative base would make time.sleep raise mid-recovery
        self.backoff_base_s = max(float(backoff_base_s), 0.0)
        self._log = log
        self._snap = None
        self._snap_sig: tuple[int, ...] | None = None
        self._chunks_since_snap = 0
        # counters for the report
        self.retries = 0  # failed dispatches retried
        self.restores = 0  # snapshot restores performed
        self.snapshots = 0  # device snapshots taken
        self.checkpoints = 0  # on-disk checkpoints written
        self.aborted = False
        self.poisoned = False  # snapshot failed its digest cross-check
        self.last_error: str | None = None
        self.syncs = 0

    def _say(self, msg: str):
        if self._log is not None:
            print(f"[supervisor] {msg}", file=self._log)

    def _sig(self, state) -> tuple[int, ...]:
        self.syncs += 1
        return state_digest_sig(state)

    def _take_snapshot(self, state):
        self._snap = snapshot_state(state)
        self._snap_sig = self._sig(self._snap)
        self._chunks_since_snap = 0
        self.snapshots += 1

    def _write_checkpoint(self):
        """The snapshot to `checkpoint_path`, atomically."""
        if self.checkpoint_path is None or self._save_fn is None:
            return
        real = self._save_fn(self.checkpoint_path + ".tmp", self._snap)
        final = self.checkpoint_path
        if real.endswith(".npz") and not final.endswith(".npz"):
            final += ".npz"
        os.replace(real, final)
        self.checkpoints += 1
        self._say(f"checkpoint written: {final}")
        kill_at = os.environ.get("SHADOW_TPU_TORCH_TEST_KILL_AT_CHECKPOINT")
        if kill_at and self.checkpoints >= int(kill_at):
            os.kill(os.getpid(), signal.SIGKILL)

    def note_state(self, state):
        """Adopt `state` as the recovery point (drivers call it once before
        their loop; the periodic refresh goes through run_chunk)."""
        self._take_snapshot(state)
        self._write_checkpoint()

    def run_chunk(self, state, dispatch):
        """Run `dispatch(state) -> state` with bounded-retry recovery.

        Returns the new state. Raises SupervisorAbort after max_retries
        consecutive failures of this chunk (or on a restore whose digest
        cross-check fails), with the supervisor's snapshot as the last good
        state (`last_good()`). The integrity sentinel's and the pressure
        plane's aborts are decisions, not failures: they propagate."""
        if self._snap is None:
            self._take_snapshot(state)
        attempt = 0
        while True:
            try:
                out = dispatch(state)
            except (KeyboardInterrupt, SystemExit, PressureAbort, IntegrityAbort):
                raise
            except Exception as e:
                self.last_error = f"{type(e).__name__}: {e}"
                attempt += 1
                self.retries += 1
                if attempt > self.max_retries:
                    self.aborted = True
                    self._say(f"giving up after {self.max_retries} retries: {self.last_error}")
                    raise SupervisorAbort(
                        f"chunk dispatch failed {attempt} times; last: {self.last_error}"
                    ) from e
                delay = self.backoff_base_s * (2 ** (attempt - 1))
                self._say(
                    f"dispatch failed ({self.last_error}); retry "
                    f"{attempt}/{self.max_retries} in {delay:.2f}s"
                )
                time.sleep(delay)
                state = self._restore_checked()
                continue
            self._chunks_since_snap += 1
            if self._chunks_since_snap >= self.snapshot_every:
                self._take_snapshot(out)
                self._write_checkpoint()
            return out

    def _restore_checked(self):
        restored = restore_snapshot(self._snap)
        sig = self._sig(restored)
        if sig != self._snap_sig:
            self.aborted = True
            self.poisoned = True
            raise SupervisorAbort(
                f"snapshot digest cross-check failed (recorded {self._snap_sig}, restored "
                f"{sig}): device state silently diverged — refusing to replay from it"
            )
        self.restores += 1
        # progress rewound to the snapshot point: restart the cadence
        self._chunks_since_snap = 0
        return restored

    def last_good(self):
        """A fresh copy of the last good snapshot, or None once it failed
        its digest cross-check (or none was taken)."""
        if self.poisoned or self._snap is None:
            return None
        return restore_snapshot(self._snap)

    def poisoned_state(self):
        """A copy of the refused snapshot, for the abort's report only (its
        `poisoned` flag keeps the counters from reading as a trusted
        prefix); None unless the cross-check failed."""
        if not self.poisoned or self._snap is None:
            return None
        return restore_snapshot(self._snap)

    def abort_export_state(self):
        """The state to report after a graceful abort: the last good
        snapshot, or the refused one when it failed its cross-check; None
        only when no snapshot was ever taken."""
        good = self.last_good()
        return good if good is not None else self.poisoned_state()

    def report(self) -> dict:
        """JSON-able summary for the report (the JAX package's keys)."""
        return {
            "retries": self.retries,
            "restores": self.restores,
            "snapshots": self.snapshots,
            "checkpoints": self.checkpoints,
            "snapshot_every_chunks": self.snapshot_every,
            "aborted": self.aborted,
            **({"poisoned": True} if self.poisoned else {}),
            **({"last_error": self.last_error} if self.last_error else {}),
        }
