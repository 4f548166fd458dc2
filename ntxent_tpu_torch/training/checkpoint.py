"""Crash-safe checkpoints and resume, counterpart of
``ntxent_tpu/training/checkpoint.py``, in the same on-disk format.

A step is the directory ``<step>/`` of:

* ``state.msgpack``: the train state in the JAX ``TrainState`` layout
  (``weights.train_state_dict``: params, optax's LARS or AdamW state,
  batch_stats, step), flax msgpack written by the port's own codec
  (``utils.msgpack``), dict keys in JAX's sorted pytree order;
* ``meta.json`` ``{"step", "format": 1}``, ``data_state.json`` (the input
  pipeline's position) and ``topology.json`` (``{"specs": {leaf path:
  null}, "mesh": {"device_count", "shape": null, "axis_names": null,
  "process_count"}, "version": 1}``: every leaf replicated, no mesh);

and the directory's ``manifests.json`` sidecar holds each step's file
sizes and CRC32s. Either package restores the other's steps.

* **Atomic steps.** A save writes into a ``.tmp-<step>-<pid>-<uuid>``
  staging directory, fsyncs every file and the directory, renames it to
  ``<step>/`` and fsyncs the parent: a kill leaves the old state or a
  staging directory, which the next manager purges once its writer's pid
  is dead.
* **Manifests.** ``verify`` re-checksums a step, ``latest_valid_step`` is
  the newest that verifies, and a restore falls back past corrupt steps
  (deleting them) to the newest valid one, or to the mirror's copy.
* **Retention.** ``RetentionPolicy`` (keep-last, keep-every) collects old
  steps after each save; the newest valid step is never collected.
* **Mirror.** ``mirror_dir`` receives a copy of every step (staged and
  renamed the same way); restore reads it when the primary is corrupt.
* **Async saves.** ``AsyncCheckpointer`` snapshots the state to host on
  the caller's thread and writes on one background thread; the loop
  blocks only while a save is already in flight. ``emergency_save``
  drains the writer and saves synchronously (the preemption path).
* **Snapshots are copies.** The port's optimizers update parameters in
  place, and ``.numpy()`` of a CPU tensor is a view, so a snapshot that
  kept views would serialize a later step under this step's label:
  ``weights.train_state_dict`` copies every tensor
  (``.to("cpu", copy=True)``) and synchronizes with the card.
* ``save`` returns False on a filesystem error (logged) and never raises:
  a skipped checkpoint is recoverable, a dead run is not. A
  ``RetryPolicy`` may wrap the physical write and read.
* Fault injection: ``fault_hook`` runs at the start of every physical
  write, on the async writer's thread too (``FaultInjector.
  on_checkpoint_write``: ``diskfull@n`` raises ENOSPC there), and
  ``NTXENT_CKPT_SLOW_MS`` sleeps that long after the state file is
  written, so a crash audit can land a SIGKILL inside a save.
* **Elastic restores.** A step saved at world P restores at world Q
  (``checkpoint.py:1101-1206``): the state is whole on the host, so the
  load re-places it, replicated state as it was, a ZeRO-3 state re-cut
  from its whole copy to Q slices by ``parallel.shards.Sharding.scatter``
  (``training.fit``), and an error-feedback residual saved at another
  world reset to zeros (``weights.load_train_state_dict``, as
  ``_from_bytes_tolerant``). Such a restore is ``reshard=
  "gather_replace"`` on its event, counted in
  ``checkpoint_reshard_total`` and its load timed in
  ``checkpoint_reshard_ms``. Only rank 0 writes.

Save, restore and fallback are logged, counted in the JAX package's
registry series (``checkpoint_saves_total`` to
``checkpoint_reshard_ms``) and emitted as ``checkpoint`` events (action
save, fallback or restore). ``stats`` keeps the save and restore times and
the state's bytes.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue as queue_mod
import shutil
import threading
import time
import uuid
import zlib
from collections.abc import Callable
from pathlib import Path

import torch

from ..obs import events as obs_events
from ..obs.registry import default_registry
from ..parallel import mesh
from ..resilience.retry import RetryBudgetExceeded
from ..utils import msgpack
from ..weights import (
    load_flax_variables,
    load_train_state_dict,
    train_state_dict,
)

logger = logging.getLogger(__name__)

__all__ = ["AsyncCheckpointer", "CheckpointManager", "RetentionPolicy",
           "Snapshot", "gather_ef_residual", "snapshot_state"]

MANIFEST_NAME = "manifests.json"
STATE_FILE = "state.msgpack"
DATA_STATE_FILE = "data_state.json"
META_FILE = "meta.json"
TOPOLOGY_FILE = "topology.json"
_TMP_PREFIX = ".tmp-"

_SAVES = default_registry().counter(
    "checkpoint_saves_total", "successful checkpoint saves")
_SAVE_FAILURES = default_registry().counter(
    "checkpoint_save_failures_total",
    "checkpoint saves skipped on filesystem errors")
_RESTORES = default_registry().counter(
    "checkpoint_restores_total", "checkpoint restores")
_FALLBACKS = default_registry().counter(
    "checkpoint_corrupt_fallbacks_total",
    "corrupt checkpoints skipped by the restore CRC fallback")
_SAVE_MS = default_registry().histogram(
    "checkpoint_save_ms", "wall time of one checkpoint save")
_QUEUE_DEPTH = default_registry().gauge(
    "checkpoint_queue_depth",
    "async checkpoint saves queued or in flight")
_ASYNC_SAVES = default_registry().counter(
    "checkpoint_async_saves_total",
    "saves handed to the background writer")
_BLOCKED_MS = default_registry().histogram(
    "checkpoint_save_blocked_ms",
    "train-loop time spent waiting for an in-flight async save")
_OVERLAP_MS = default_registry().histogram(
    "checkpoint_save_overlap_ms",
    "background-writer wall time per save (hidden under compute)")
_GC_DELETED = default_registry().counter(
    "checkpoint_gc_deleted_total",
    "checkpoint steps removed by the retention policy")
_MIRROR_COPIES = default_registry().counter(
    "checkpoint_mirror_copies_total",
    "checkpoint steps replicated to the mirror directory")
_MIRROR_FAILURES = default_registry().counter(
    "checkpoint_mirror_failures_total",
    "mirror replications skipped on filesystem errors")
_MIRROR_RESTORES = default_registry().counter(
    "checkpoint_mirror_restores_total",
    "restores served from the mirror after primary corruption/loss")
_RESHARDS = default_registry().counter(
    "checkpoint_reshard_total",
    "restores that re-placed state onto a mesh differing from the "
    "recorded save-time topology")
_RESHARD_MS = default_registry().histogram(
    "checkpoint_reshard_ms",
    "wall time of the host-gather -> re-place step on topology-"
    "mismatched restores")


def _crc32_file(path: Path, chunk: int = 1 << 20) -> int:
    value = 0
    with open(path, "rb") as f:
        while block := f.read(chunk):
            value = zlib.crc32(block, value)
    return value


def _fsync_path(path: Path) -> None:
    """fsync a file or a directory (a directory's fsync persists its
    entries)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _staging_name(step: int) -> str:
    """``.tmp-<step>-<pid>-<uuid>``: the pid tells a killed writer's debris
    from another live process's save in flight."""
    return f"{_TMP_PREFIX}{int(step)}-{os.getpid()}-{uuid.uuid4().hex[:8]}"


def _staging_pid(name: str) -> int | None:
    parts = name[len(_TMP_PREFIX):].split("-")
    if len(parts) >= 3 and parts[1].isdigit():
        return int(parts[1])
    return None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # it exists, owned by someone else
    except OSError:
        return False


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order: the order JAX's
    pytree flattening gives a state dict, so the port writes the bytes the
    JAX package writes for the same state."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _leaf_paths(tree, prefix: str = ""):
    """``a/b/c`` paths of the leaves of a state dict, as JAX flattens it:
    None and empty dicts hold no leaf."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaf_paths(value, f"{prefix}{key}/")
    elif tree is not None:
        yield prefix[:-1]


def _mesh_record() -> dict:
    world = mesh.world_topology()
    return {key: world[key] for key in ("device_count", "shape",
                                        "axis_names", "process_count")}


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """A host copy of a train state (a numpy state dict in the JAX layout)
    and its topology record, ready for a background write."""

    state_dict: dict
    topology: dict


def gather_ef_residual(state, group=None) -> dict | None:
    """Every rank's error-feedback residual, stacked: ``{parameter name:
    (P,) + shape}`` host float32 arrays, rank r's slice at r (None when
    the state carries none). A collective: every rank of ``group`` calls
    it at once (one all-gather of the flat residual); a world of one
    gathers nothing."""
    if getattr(state, "ef_residual", None) is None:
        return None
    local = torch.cat([e.detach().reshape(-1) for e in state.ef_residual])
    p = mesh.world_size(group)
    if p > 1:
        parts = [torch.empty_like(local) for _ in range(p)]
        # ntxent: lint-ok[collective-shim] a save's gather
        torch.distributed.all_gather(parts, local.contiguous(), group=group)
        local = torch.stack(parts)
    else:
        local = local[None]
    host = local.to("cpu", copy=True).numpy()
    names = [n for n, _ in state.model.named_parameters()]
    out, lo = {}, 0
    for name, e in zip(names, state.ef_residual):
        out[name] = host[:, lo:lo + e.numel()].reshape((p, *e.shape))
        lo += e.numel()
    return out


def snapshot_state(state, keep_ef_residual: bool = False,
                   ef_residual: dict | None = None) -> Snapshot:
    """A ``Snapshot`` of a port ``TrainState``: every tensor copied to the
    host (a copy of its own, never a view), the caller's only part of an
    async save. A ``Snapshot`` passes through.

    Slim by default (``checkpoint.py:237-280``): a state that carries an
    error-feedback residual is saved without the ``ef_residual`` field,
    which a restore turns into zeros. ``keep_ef_residual`` saves it in
    the JAX layout: ``ef_residual`` as ``gather_ef_residual`` stacked it
    on every rank, or, in a world of one, this rank's own."""
    if isinstance(state, Snapshot):
        return state
    has_ef = getattr(state, "ef_residual", None) is not None
    if keep_ef_residual and has_ef and ef_residual is None:
        if mesh.world_size() > 1:
            raise ValueError("saving the error-feedback residual in a world "
                             "of several ranks needs every rank's slice: "
                             "pass ef_residual=gather_ef_residual(state), "
                             "called on every rank")
        ef_residual = gather_ef_residual(state)
    state_dict = train_state_dict(
        state, ef_residual if keep_ef_residual else None)
    if has_ef and not keep_ef_residual:
        del state_dict["ef_residual"]  # the JAX slim save drops the field
    state_dict = _sorted(state_dict)
    topology = {"specs": {path: None for path in _leaf_paths(state_dict)},
                "mesh": _mesh_record(), "version": 1}
    return Snapshot(state_dict, topology)


@dataclasses.dataclass(frozen=True)
class RetentionPolicy:
    """keep-last-k + keep-every-n collection of checkpoint steps: the
    ``keep_last`` newest steps, the multiples of ``keep_every`` and the
    newest VALID step survive (``keep_last`` None or 0 keeps all)."""

    keep_last: int | None = 3
    keep_every: int | None = None

    def keep(self, steps: list[int],
             is_valid: Callable[[int], bool]) -> set[int]:
        steps = sorted(set(int(s) for s in steps))
        if not self.keep_last or len(steps) <= int(self.keep_last):
            return set(steps)
        kept = set(steps[-int(self.keep_last):])
        if self.keep_every:
            kept |= {s for s in steps if s % int(self.keep_every) == 0}
        newest_valid = next((s for s in reversed(steps) if is_valid(s)),
                            None)
        if newest_valid is not None:
            kept.add(newest_valid)
        return kept


class _UnreadableStepError(RuntimeError):
    """A step that verifies but cannot be read into the state (a foreign
    format); never deleted by the fallback."""


def _write_state(path: Path, tree) -> list[int]:
    """Stream ``tree``'s msgpack to ``path``; returns [size, crc32] of
    the bytes written (no second read of a multi-GB file)."""
    size, crc = 0, 0
    with open(path, "wb") as f:
        def write(piece):
            nonlocal size, crc
            f.write(piece)
            size += len(piece)
            crc = zlib.crc32(piece, crc)

        msgpack.pack(tree, write)
    return [size, crc]


def _write_delay_s() -> float:
    """The write throttle ``NTXENT_CKPT_SLOW_MS`` in seconds (0 unset or
    unreadable)."""
    try:
        return max(0.0, float(os.environ.get("NTXENT_CKPT_SLOW_MS", "0"))
                   ) / 1e3
    except ValueError:
        return 0.0


class _Backend:
    """The physical store: atomic step directories under ``root``."""

    def __init__(self, root: Path, fault_hook: Callable | None = None):
        self.root = root
        self.fault_hook = fault_hook
        self.last_write_manifest: tuple[int, dict] | None = None
        self.root.mkdir(parents=True, exist_ok=True)
        self.purge_tmp()

    def step_dirs(self) -> dict[int, Path]:
        out = {}
        try:
            entries = list(self.root.iterdir())
        except OSError:
            return out
        for p in entries:
            if p.is_dir() and not p.name.startswith(_TMP_PREFIX) \
                    and p.name.isdigit():
                out[int(p.name)] = p
        return out

    def all_steps(self) -> list[int]:
        return sorted(self.step_dirs())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> Path | None:
        return self.step_dirs().get(int(step))

    def purge_tmp(self) -> None:
        """Remove the staging directories of killed writers (a live
        writer's, another process's save in flight, stays)."""
        try:
            entries = list(self.root.iterdir())
        except OSError:
            return
        for p in entries:
            if not (p.is_dir() and p.name.startswith(_TMP_PREFIX)):
                continue
            pid = _staging_pid(p.name)
            if pid is not None and pid != os.getpid() and _pid_alive(pid):
                logger.info("keeping checkpoint staging dir %s: its writer "
                            "(pid %d) is alive", p, pid)
                continue
            logger.warning("purging abandoned checkpoint staging dir %s "
                           "(killed mid-save)", p)
            shutil.rmtree(p, ignore_errors=True)

    def save(self, step: int, snapshot: Snapshot,
             data_state: dict | None = None, force: bool = False) -> bool:
        """Write one step directory atomically; raises OSError on
        filesystem trouble. An existing step stays unless ``force``."""
        if self.fault_hook is not None:
            self.fault_hook()
        step = int(step)
        final = self.root / str(step)
        tmp = self.root / _staging_name(step)
        tmp.mkdir()
        try:
            files = {STATE_FILE: _write_state(tmp / STATE_FILE,
                                              snapshot.state_dict)}
            delay = _write_delay_s()
            if delay:
                time.sleep(delay)

            def write(name: str, payload: bytes) -> None:
                with open(tmp / name, "wb") as f:
                    f.write(payload)
                files[name] = [len(payload), zlib.crc32(payload)]

            if data_state is not None:
                write(DATA_STATE_FILE, json.dumps(data_state).encode())
            write(TOPOLOGY_FILE, json.dumps(snapshot.topology).encode())
            write(META_FILE, json.dumps({"step": step, "format": 1}).encode())
            for p in tmp.iterdir():
                _fsync_path(p)
            _fsync_path(tmp)
            if final.exists():
                if not force:
                    shutil.rmtree(tmp, ignore_errors=True)
                    return False
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync_path(self.root)
            self.last_write_manifest = (step, {"files": files})
            return True
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def delete(self, step: int) -> None:
        step_dir = self.step_dir(step)
        if step_dir is not None:
            shutil.rmtree(step_dir)


def _read_step_payload(step_dir: Path) -> tuple[bytes, dict | None]:
    blob = (step_dir / STATE_FILE).read_bytes()
    ds_path = step_dir / DATA_STATE_FILE
    data_state = json.loads(ds_path.read_text()) if ds_path.exists() \
        else None
    return blob, data_state


class CheckpointManager:
    """Crash-safe checkpoint store for the port's ``TrainState``.

    ``max_to_keep`` / ``keep_every`` set the ``RetentionPolicy``;
    ``save_interval_steps`` the cadence of ``should_save`` (the first save
    of an empty directory always lands); ``verify_writes`` records the CRC
    manifests; ``mirror_dir`` replicates every step; ``retry_policy``
    retries the physical write and read on transient errors;
    ``fault_hook`` runs at the start of each physical write of the
    primary copy. ``save_ef_residual`` keeps the int8 wire's
    error-feedback residual in each step (``--ckpt-save-ef``; slim saves
    drop it, ``snapshot_state``)."""

    def __init__(self, directory: str | Path, max_to_keep: int | None = 3,
                 save_interval_steps: int = 1, retry_policy=None,
                 verify_writes: bool = True, keep_every: int | None = None,
                 mirror_dir: str | Path | None = None,
                 fault_hook: Callable | None = None,
                 save_ef_residual: bool = False):
        self.directory = Path(directory).absolute()
        self.save_ef_residual = save_ef_residual
        self.retry_policy = retry_policy
        self.verify_writes = verify_writes
        self.save_interval_steps = max(1, int(save_interval_steps))
        self.retention = RetentionPolicy(keep_last=max_to_keep,
                                         keep_every=keep_every)
        self.manager = _Backend(self.directory, fault_hook=fault_hook)
        self.mirror_dir = Path(mirror_dir).absolute() \
            if mirror_dir is not None else None
        self._mirror = _Backend(self.mirror_dir) \
            if self.mirror_dir is not None else None
        self._has_any_step = False
        # save ms (host clock around the write, manifest, mirror and gc),
        # restore ms, the state file's bytes
        self.stats = {"save_ms": [], "restore_ms": [], "state_bytes": None}
        self._load_ms = 0.0  # the last restore's load

    def _call(self, fn, *args, **kwargs):
        if self.retry_policy is not None:
            return self.retry_policy.call(fn, *args, **kwargs)
        return fn(*args, **kwargs)

    # -- manifests ---------------------------------------------------------
    def _manifest_path(self, root: Path | None = None) -> Path:
        return (root or self.directory) / MANIFEST_NAME

    def _load_manifests(self, root: Path | None = None) -> dict:
        try:
            with open(self._manifest_path(root)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def _store_manifests(self, manifests: dict,
                         root: Path | None = None) -> None:
        target = self._manifest_path(root)
        tmp = target.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(manifests, f)
        os.replace(tmp, target)

    def _step_dir(self, step: int) -> Path | None:
        return self.manager.step_dir(step)

    @staticmethod
    def _compute_manifest(step_dir: Path | None) -> dict | None:
        if step_dir is None or not step_dir.is_dir():
            return None
        return {"files": {str(p.relative_to(step_dir)):
                          [p.stat().st_size, _crc32_file(p)]
                          for p in sorted(step_dir.rglob("*"))
                          if p.is_file()}}

    def _record_manifest(self, step: int, root: Path | None = None,
                         manifest: dict | None = None) -> None:
        backend = self._mirror if root is not None \
            and root == self.mirror_dir else self.manager
        if manifest is None:
            last = self.manager.last_write_manifest
            if last is not None and last[0] == int(step):
                manifest = last[1]
            else:
                manifest = self._compute_manifest(backend.step_dir(step))
        if manifest is None:
            logger.warning("no step dir found for step %d; skipping its "
                           "checksum manifest", step)
            return
        manifests = self._load_manifests(root)
        manifests[str(step)] = manifest
        live = {str(s) for s in backend.all_steps()}
        self._store_manifests({k: v for k, v in manifests.items()
                               if k in live}, root)

    def _verify_in(self, backend: _Backend, root: Path, step: int) -> bool:
        recorded = self._load_manifests(root).get(str(step))
        step_dir = backend.step_dir(step)
        if recorded is None:
            # no manifest (verify_writes off, or a kill between rename and
            # manifest): an atomically renamed step is complete
            return step_dir is not None
        actual = self._compute_manifest(step_dir)
        if actual is None:
            return False
        for rel, meta in recorded["files"].items():
            if actual["files"].get(rel) != meta:
                logger.error("checkpoint step %d failed verification at %s "
                             "(want size/crc %s, got %s)", step, rel, meta,
                             actual["files"].get(rel))
                return False
        return True

    def verify(self, step: int) -> bool:
        """Re-checksum a step against its manifest (True for a step with
        none: unverifiable is not invalid)."""
        return self._verify_in(self.manager, self.directory, step)

    def mirror_verify(self, step: int) -> bool:
        """``verify`` against the mirror's copy (False without a mirror)."""
        if self._mirror is None:
            return False
        return self._verify_in(self._mirror, self.mirror_dir, step)

    def latest_valid_step(self) -> int | None:
        """The newest step that verifies in the primary or the mirror."""
        candidates = set(self.manager.all_steps())
        if self._mirror is not None:
            candidates |= set(self._mirror.all_steps())
        for step in sorted(candidates, reverse=True):
            if self._step_dir(step) is not None and self.verify(step):
                return int(step)
            if self.mirror_verify(step):
                return int(step)
        return None

    def delete_step(self, step: int, reason: str = "corrupt") -> None:
        """Remove a step and its manifest entry from the primary (the
        mirror keeps its copy). The entry goes only once the files are
        gone, so a step that could not be deleted stays invalid."""
        try:
            self.manager.delete(step)
        except OSError:
            step_dir = self._step_dir(step)
            if step_dir is not None:
                shutil.rmtree(step_dir, ignore_errors=True)
        if self._step_dir(step) is not None:
            logger.error("could not delete %s checkpoint at step %d; "
                         "keeping its manifest so it stays invalid",
                         reason, step)
            return
        manifests = self._load_manifests()
        if manifests.pop(str(step), None) is not None:
            try:
                self._store_manifests(manifests)
            except OSError as e:
                logger.error("manifest rewrite after deleting step %d "
                             "failed (%s)", step, e)
        logger.warning("deleted %s checkpoint at step %d", reason, step)

    # -- retention and the mirror ------------------------------------------
    def _gc_mirror(self, just_saved: int | None) -> None:
        m_steps = self._mirror.all_steps()
        kept = self.retention.keep(m_steps, lambda s: s == just_saved
                                   or self.mirror_verify(s))
        manifests = self._load_manifests(self.mirror_dir)
        changed = False
        for step in m_steps:
            if step in kept:
                continue
            try:
                self._mirror.delete(step)
            except OSError:
                continue
            changed |= manifests.pop(str(step), None) is not None
        if changed:
            try:
                self._store_manifests(manifests, self.mirror_dir)
            except OSError:
                pass

    def gc(self, just_saved: int | None = None) -> list[int]:
        """Apply the retention policy (to the mirror too); returns the
        primary steps deleted. ``just_saved`` counts as valid without
        re-reading its bytes."""
        steps = self.manager.all_steps()
        kept = self.retention.keep(steps, lambda s: s == just_saved
                                   or self.verify(s))
        deleted = []
        for step in steps:
            if step in kept:
                continue
            self.delete_step(step, reason="retired")
            if self._step_dir(step) is None:
                deleted.append(step)
                _GC_DELETED.inc()
        if self._mirror is not None:
            self._gc_mirror(just_saved)
        if deleted:
            logger.info("retention GC removed steps %s (policy %s)",
                        deleted, self.retention)
        return deleted

    def _replicate(self, step: int) -> None:
        """Copy one saved step to the mirror (staged, renamed). Mirror
        trouble never fails the primary save: it is logged, and the next
        save tries again."""
        src = self._step_dir(step) if self._mirror is not None else None
        if src is None:
            return
        tmp = self.mirror_dir / _staging_name(step)
        try:
            shutil.copytree(src, tmp)
            for p in tmp.rglob("*"):
                if p.is_file():
                    _fsync_path(p)
            _fsync_path(tmp)
            final = self.mirror_dir / str(int(step))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync_path(self.mirror_dir)
            if self.verify_writes:
                self._record_manifest(
                    step, root=self.mirror_dir,
                    manifest=self._load_manifests().get(str(step)))
            _MIRROR_COPIES.inc()
        except OSError as e:
            shutil.rmtree(tmp, ignore_errors=True)
            _MIRROR_FAILURES.inc()
            logger.error("mirror replication of step %d failed (%s); the "
                         "primary save stands", step, e)

    # -- save and restore --------------------------------------------------
    def should_save(self, step: int, force: bool = False) -> bool:
        """The save cadence: ``force``, a multiple of
        ``save_interval_steps``, or the first save of an empty
        directory."""
        return self._cadence(step, force, claim=False)

    def _claim_save(self, step: int, force: bool = False) -> bool:
        return self._cadence(step, force, claim=True)

    def _cadence(self, step: int, force: bool, claim: bool) -> bool:
        if force or int(step) % self.save_interval_steps == 0:
            return True
        if self._has_any_step:
            return False
        if self.manager.latest_step() is not None:
            self._has_any_step = True
            return False
        # an empty directory: this is the first save; a claim marks it
        # taken now, while an async writer may still be writing it
        if claim:
            self._has_any_step = True
        return True

    def snapshot(self, state, ef_residual: dict | None = None) -> Snapshot:
        return snapshot_state(state, self.save_ef_residual, ef_residual)

    def save(self, step: int, state, force: bool = False,
             data_state: dict | None = None, emergency: bool = False,
             _prefiltered: bool = False,
             ef_residual: dict | None = None) -> bool:
        """Save ``state`` (a ``TrainState`` or a ``Snapshot``) at ``step``
        with the input pipeline's ``data_state``. Returns False, after
        logging, when the write hits a filesystem error; the next cadence
        point saves again. Only rank 0 of a process group writes;
        ``ef_residual`` is every rank's residual (``gather_ef_residual``)
        when the manager keeps it in a world of several ranks."""
        step = int(step)
        if mesh.rank() != 0:
            return False
        if not _prefiltered and not self._claim_save(step, force):
            return False
        t0 = time.perf_counter()
        try:
            saved = self._call(self.manager.save, step,
                               self.snapshot(state, ef_residual),
                               data_state=data_state, force=force)
        except (OSError, RetryBudgetExceeded) as e:
            logger.error("checkpoint save at step %d failed (%s: %s); "
                         "continuing without it", step, type(e).__name__, e)
            _SAVE_FAILURES.inc()
            obs_events.emit("checkpoint", action="save", step=step,
                            ok=False, error=f"{type(e).__name__}: {e}")
            self._has_any_step = self.manager.latest_step() is not None
            return False
        if saved:
            self._has_any_step = True
            if self.verify_writes:
                try:
                    self._record_manifest(step)
                except OSError as e:
                    logger.error("checksum manifest for step %d failed (%s); "
                                 "the step stays unverifiable", step, e)
            try:
                self._replicate(step)
                self.gc(just_saved=step)
            except OSError as e:
                logger.error("post-save housekeeping for step %d failed "
                             "(%s); the save itself stands", step, e)
            ms = (time.perf_counter() - t0) * 1e3
            self.stats["save_ms"].append(ms)
            self.stats["state_bytes"] = \
                self.manager.last_write_manifest[1]["files"][STATE_FILE][0]
            _SAVES.inc()
            _SAVE_MS.observe(ms)
            obs_events.emit("checkpoint", action="save", step=step,
                            ok=True, forced=bool(force),
                            emergency=bool(emergency),
                            duration_ms=round(ms, 3),
                            verified=bool(self.verify_writes))
            logger.info("checkpoint saved at step %d -> %s in %.1f ms%s",
                        step, self.directory, ms,
                        " (emergency)" if emergency else "")
        return saved

    def _restore_sources(self):
        yield self.manager, self.directory, "primary"
        if self._mirror is not None:
            yield self._mirror, self.mirror_dir, "mirror"

    def _load_step(self, step: int, load) -> tuple[dict | None, str]:
        """Read ``step`` through ``load(state dict)`` from the first source
        whose copy verifies and loads. Raises ``_UnreadableStepError`` when a copy
        verified but would not load (a foreign format: not deleted), and
        FileNotFoundError when no source has a valid copy."""
        unreadable = False
        for backend, root, label in self._restore_sources():
            step_dir = backend.step_dir(step)
            if step_dir is None or not self._verify_in(backend, root, step):
                continue
            try:
                blob, data_state = self._call(_read_step_payload, step_dir)
                self._timed_load(load, blob)
            except (OSError, ValueError, KeyError, TypeError) as e:
                unreadable = True
                logger.error("checkpoint step %d in %s is unreadable despite "
                             "passing verification (%s: %s)", step, root,
                             type(e).__name__, e)
                continue
            if label == "mirror":
                _MIRROR_RESTORES.inc()
                logger.warning("restoring step %d from the MIRROR (%s): the "
                               "primary copy is corrupt or missing", step,
                               self.mirror_dir)
            return data_state, label
        if unreadable:
            raise _UnreadableStepError(
                f"step {step} in {self.directory} passes verification but "
                "does not load into this state (another model or format)")
        raise FileNotFoundError(
            f"step {step} has no valid copy in {self.directory}"
            + (f" or {self.mirror_dir}" if self._mirror else ""))

    def _timed_load(self, load, blob: bytes) -> None:
        """``load`` the decoded state; its wall time is the re-place
        step's (``checkpoint_reshard_ms``) when the world changed."""
        t0 = time.perf_counter()
        load(msgpack.from_bytes(blob))
        self._load_ms = (time.perf_counter() - t0) * 1e3

    def _load_topology(self, step: int) -> dict | None:
        for backend, _root, _label in self._restore_sources():
            step_dir = backend.step_dir(step)
            if step_dir is None:
                continue
            try:
                return json.loads((step_dir / TOPOLOGY_FILE).read_text())
            except FileNotFoundError:
                continue
            except (OSError, json.JSONDecodeError) as e:
                logger.warning("unreadable topology of step %d (%s)", step,
                               e)
        return None

    def restore(self, state, step: int | None = None):
        return self.restore_with_data_state(state, step)[0]

    def restore_with_data_state(self, state, step: int | None = None):
        """Load a step into the port ``TrainState`` ``state`` in place;
        returns ``(state, data_state or None)``. With ``step=None`` the
        newest step that verifies and loads, primary first, then its
        mirror copy, deleting corrupt primaries on the way down; an
        explicit ``step`` is loaded even after a failed verification
        (logged): the caller asked for it."""
        _, data_state = self._restore(
            lambda tree: load_train_state_dict(state, tree), step)
        return state, data_state

    def restore_variables(self, model, step: int | None = None) -> int:
        """Load only the ``params`` and ``batch_stats`` of a step into
        ``model`` (serving: no optimizer needed, so any optimizer layout
        reads), with ``restore``'s choice of step; returns the step."""
        def load(tree: dict) -> None:
            load_flax_variables(model, {
                "params": tree["params"],
                "batch_stats": tree.get("batch_stats") or {}})

        return self._restore(load, step)[0]

    def _restore(self, load, step: int | None):
        t0 = time.perf_counter()
        if step is None:
            candidates = set(self.manager.all_steps())
            if self._mirror is not None:
                candidates |= set(self._mirror.all_steps())
            if not candidates:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
            chosen, unreadable = None, None
            for cand in sorted(candidates, reverse=True):
                try:
                    chosen = self._load_step(cand, load)
                    step = cand
                    break
                except _UnreadableStepError as e:
                    # not provable corruption: kept on disk, skipped
                    unreadable = e
                    obs_events.emit("checkpoint", action="fallback",
                                    step=int(cand), ok=False,
                                    reason="unreadable")
                except FileNotFoundError:
                    logger.error("checkpoint at step %d is corrupt in every "
                                 "replica; falling back to the previous one",
                                 cand)
                    _FALLBACKS.inc()
                    obs_events.emit("checkpoint", action="fallback",
                                    step=int(cand), ok=False)
                    self.delete_step(cand)
            if chosen is None:
                if unreadable is not None:
                    raise unreadable
                raise FileNotFoundError(
                    f"no VALID checkpoint left in {self.directory} (every "
                    "candidate failed its checksums)")
        elif self.verify(step) or self.mirror_verify(step):
            chosen = self._load_step(step, load)
        else:
            logger.error("explicitly requested checkpoint step %d fails "
                         "verification; restoring it anyway", step)
            source, step_dir = "primary", self._step_dir(step)
            if step_dir is None and self._mirror is not None:
                source, step_dir = "mirror", self._mirror.step_dir(step)
            if step_dir is None:
                raise FileNotFoundError(f"no checkpoint for step {step} in "
                                        f"{self.directory}")
            blob, data_state = self._call(_read_step_payload, step_dir)
            self._timed_load(load, blob)
            chosen = (data_state, source)
        data_state, source = chosen
        saved = (self._load_topology(step) or {}).get("mesh") or {}
        world = _mesh_record()
        changed = bool(saved) and saved.get("device_count") \
            != world["device_count"]
        if changed:
            _RESHARDS.inc()
            _RESHARD_MS.observe(self._load_ms)
        ms = (time.perf_counter() - t0) * 1e3
        self.stats["restore_ms"].append(ms)
        _RESTORES.inc()
        obs_events.emit("checkpoint", action="restore", step=int(step),
                        ok=True, source=source,
                        reshard="gather_replace" if changed else "none",
                        duration_ms=round(ms, 3))
        logger.info("checkpoint step %d restored from the %s copy in %.1f "
                    "ms; topology %s (saved at world %s, restored at world "
                    "%d)", step, source, ms,
                    "changed: the state re-placed" if changed
                    else "unchanged", saved.get("device_count", "unknown"),
                    world["device_count"])
        return step, data_state

    def truncate_after(self, step: int) -> list[int]:
        """Delete every step newer than ``step`` in the primary and the
        mirror: a replay from a historical step owns the timeline from
        there. Returns the deleted steps."""
        step = int(step)
        deleted = set()
        for s in [s for s in self.manager.all_steps() if s > step]:
            self.delete_step(s, reason="rewind")
            if self._step_dir(s) is None:
                deleted.add(s)
        if self._mirror is not None:
            manifests = self._load_manifests(self.mirror_dir)
            for s in [s for s in self._mirror.all_steps() if s > step]:
                try:
                    self._mirror.delete(s)
                except OSError:
                    continue
                deleted.add(s)
                manifests.pop(str(s), None)
            try:
                self._store_manifests(manifests, self.mirror_dir)
            except OSError:
                pass
        return sorted(deleted)

    def latest_step(self) -> int | None:
        return self.manager.latest_step()

    def all_steps(self) -> list[int]:
        return self.manager.all_steps()

    def wait_until_finished(self) -> None:
        """Synchronous saves: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release (``AsyncCheckpointer`` owns a thread)."""


class AsyncCheckpointer:
    """A bounded background writer around a ``CheckpointManager``.

    ``save`` snapshots the state on the caller's thread (the device-to-
    host copy) and queues the write, manifest, mirror and collection for
    one writer thread. At most ``max_pending`` saves are outstanding: the
    loop blocks, before taking the next snapshot, only when that many are
    in flight. A failed write is logged and kept in ``last_error``; it
    never raises into the loop. ``stats["blocked_ms"]`` holds the time
    each accepted save held the loop (wait and snapshot)."""

    def __init__(self, manager: CheckpointManager, max_pending: int = 1):
        self.manager = manager
        self.max_pending = max(1, int(max_pending))
        self._queue: queue_mod.Queue = queue_mod.Queue(
            maxsize=self.max_pending)
        self.last_error: BaseException | None = None
        self.stats = {"blocked_ms": []}
        self._closed = False
        self._thread = threading.Thread(target=self._writer, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def _writer(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                step, snapshot, data_state, force = job
                t0 = time.perf_counter()
                try:
                    self.manager.save(step, snapshot, force=force,
                                      data_state=data_state,
                                      _prefiltered=True)
                except BaseException as e:  # never kill the writer
                    self.last_error = e
                    logger.exception("async checkpoint writer: the save at "
                                     "step %d died", step)
                _OVERLAP_MS.observe((time.perf_counter() - t0) * 1e3)
            finally:
                self._queue.task_done()
                _QUEUE_DEPTH.set(self._queue.qsize())

    def save(self, step: int, state, force: bool = False,
             data_state: dict | None = None,
             ef_residual: dict | None = None) -> bool:
        """Accept a save: snapshot now, write in the background. True when
        the save was queued."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        step = int(step)
        if mesh.rank() != 0 or not self.manager._claim_save(step, force):
            return False
        t0 = time.perf_counter()
        if self._queue.unfinished_tasks >= self.max_pending:
            # bounded work, waited for before the snapshot: no more than
            # max_pending host copies of the state exist at once
            self._queue.join()
            _BLOCKED_MS.observe((time.perf_counter() - t0) * 1e3)
        snapshot = self.manager.snapshot(state, ef_residual)
        self._queue.put((step, snapshot, data_state, force))
        self.stats["blocked_ms"].append((time.perf_counter() - t0) * 1e3)
        _QUEUE_DEPTH.set(self._queue.qsize())
        _ASYNC_SAVES.inc()
        return True

    def emergency_save(self, step: int, state,
                       data_state: dict | None = None,
                       ef_residual: dict | None = None) -> bool:
        """The preemption path: drain pending writes, then save ``state``
        synchronously. Never raises on filesystem trouble."""
        try:
            self.wait_until_finished()
            return self.manager.save(step, state, force=True,
                                     data_state=data_state, emergency=True,
                                     ef_residual=ef_residual)
        except Exception:
            logger.exception("emergency checkpoint save at step %d died",
                             step)
            return False

    @property
    def directory(self) -> Path:
        return self.manager.directory

    def should_save(self, step: int, force: bool = False) -> bool:
        return self.manager.should_save(step, force)

    def verify(self, step: int) -> bool:
        self.wait_until_finished()
        return self.manager.verify(step)

    def latest_valid_step(self) -> int | None:
        self.wait_until_finished()
        return self.manager.latest_valid_step()

    def latest_step(self) -> int | None:
        return self.manager.latest_step()

    def all_steps(self) -> list[int]:
        return self.manager.all_steps()

    def delete_step(self, step: int, reason: str = "corrupt") -> None:
        self.manager.delete_step(step, reason)

    def truncate_after(self, step: int) -> list[int]:
        self.wait_until_finished()
        return self.manager.truncate_after(step)

    def restore(self, state, step: int | None = None):
        self.wait_until_finished()
        return self.manager.restore(state, step)

    def restore_with_data_state(self, state, step: int | None = None):
        self.wait_until_finished()
        return self.manager.restore_with_data_state(state, step)

    def wait_until_finished(self) -> None:
        self._queue.join()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.wait_until_finished()
        self._queue.put(None)
        self._thread.join(timeout=10.0)
        self.manager.close()
