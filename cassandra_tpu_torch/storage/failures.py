"""Storage failure policies: the FSErrorHandler / JVMStabilityInspector
role.

Reference counterpart: config/Config.java DiskFailurePolicy /
CommitFailurePolicy, service/DefaultFSErrorHandler.java and
utils/JVMStabilityInspector.java — every FSError /
CorruptSSTableException on the live path funnels into one policy
decision instead of propagating as an unhandled crash.

Policies (cassandra.yaml semantics):

    disk_failure_policy
        die          the node is unusable: fire the die listeners (a
                     daemon would exit; in-process nodes mark themselves
                     dead) — reads and writes refuse from then on
        stop         leave the ring (gossip stops, status=shutdown via
                     the registered stop listeners) and refuse reads and
                     writes; the process survives for inspection
        best_effort  quarantine the failing sstable / skip the failing
                     source and keep serving from what remains (you may
                     see obsolete data at CL.ONE — the reference says
                     the same)
        ignore       count the failure and let the request fail
                     (pre-policy behavior)

    commit_failure_policy
        die / stop   as above
        stop_commit  halt ACCEPTING writes (commitlog durability can no
                     longer be promised) while reads continue
        ignore       count and keep going: the sync error still fails
                     the writers parked on that sync, but nothing is
                     gated afterwards

The handler is engine-scoped (in-process multi-node clusters each get
their own) and subscribes to the mutable config knobs so `nodetool` /
the settings vtable can flip policies live. Failure *counters*
(`storage.disk_failures`, `storage.corruption_detected`,
`storage.commit_failures`) land in the process-global metrics registry.
"""
from __future__ import annotations

import logging
import threading
import time

DISK_POLICIES = ("die", "stop", "best_effort", "ignore")
COMMIT_POLICIES = ("die", "stop", "stop_commit", "ignore")

_log = logging.getLogger(__name__)


class StorageStoppedError(Exception):
    """The node refused the request because a failure policy (die/stop)
    took the storage layer out of service."""


class CommitLogStoppedError(StorageStoppedError):
    """Writes refused under commit_failure_policy=stop_commit; reads
    continue."""


class FailureHandler:
    """One `handle(err, path)` entry point per failure class. Storage
    code never interprets the policy itself: it reports the error here
    and acts on the returned policy string (best_effort callers
    quarantine/degrade; everything else re-raises)."""

    RECENT_ERRORS = 32

    def __init__(self, settings=None):
        self._lock = threading.Lock()
        self._settings = settings
        self.disk_policy = "best_effort"
        self.commit_policy = "ignore"
        if settings is not None:
            self._set_disk_policy(settings.get("disk_failure_policy"))
            self._set_commit_policy(settings.get("commit_failure_policy"))
            settings.on_change("disk_failure_policy",
                               self._set_disk_policy)
            settings.on_change("commit_failure_policy",
                               self._set_commit_policy)
        # terminal states; monotonic (nothing un-stops a node)
        self.storage_stopped = False
        self.commits_stopped = False
        self.dead = False
        self._stop_listeners: list = []
        self._die_listeners: list = []
        self.errors: list[dict] = []   # bounded recent tail (diagnostics)
        # black box (service/diagnostics.FlightRecorder), wired by the
        # engine: terminal policy transitions (stop/die/stop_commit)
        # and quarantines dump a post-incident bundle through it
        self.flight_recorder = None

    # ------------------------------------------------------------- config

    def _set_disk_policy(self, v: str) -> None:
        if v not in DISK_POLICIES:
            from ..config import ConfigError
            raise ConfigError(
                f"disk_failure_policy must be one of {DISK_POLICIES}, "
                f"got {v!r}")
        self.disk_policy = v

    def _set_commit_policy(self, v: str) -> None:
        if v not in COMMIT_POLICIES:
            from ..config import ConfigError
            raise ConfigError(
                f"commit_failure_policy must be one of {COMMIT_POLICIES},"
                f" got {v!r}")
        self.commit_policy = v

    def close(self) -> None:
        if self._settings is not None:
            self._settings.remove_listener("disk_failure_policy",
                                           self._set_disk_policy)
            self._settings.remove_listener("commit_failure_policy",
                                           self._set_commit_policy)

    # ---------------------------------------------------------- listeners

    def on_stop(self, cb) -> None:
        """cb(err): fired ONCE when a `stop` (or `die`) policy trips —
        the Node registers its leave-the-ring transition here
        (StorageService.stopTransports role)."""
        self._stop_listeners.append(cb)

    def on_die(self, cb) -> None:
        self._die_listeners.append(cb)

    # ------------------------------------------------------------ handle

    def handle_disk(self, err: BaseException, path: str = "") -> str:
        """An FSError-class failure (EIO, ENOSPC, short read...) on the
        storage layer. Counts storage.disk_failures and applies
        disk_failure_policy; returns the policy so the caller knows
        whether to degrade (best_effort) or re-raise."""
        from ..service.metrics import GLOBAL
        GLOBAL.incr("storage.disk_failures")
        return self._apply_disk(err, path, kind="disk")

    def handle_corruption(self, err: BaseException, path: str = "") -> str:
        """A CorruptSSTableError-class failure: data on disk is wrong,
        not just unreachable. Counts storage.corruption_detected and
        applies disk_failure_policy (the reference routes
        CorruptSSTableException through the same policy)."""
        from ..service.metrics import GLOBAL
        GLOBAL.incr("storage.corruption_detected")
        return self._apply_disk(err, path, kind="corruption")

    def handle(self, err: BaseException, path: str = "") -> str:
        """Classify-and-dispatch convenience: CorruptSSTableError-shaped
        errors count as corruption, everything else as a disk failure."""
        from .sstable.reader import CorruptSSTableError
        if isinstance(err, CorruptSSTableError):
            return self.handle_corruption(err, path)
        return self.handle_disk(err, path)

    def handle_commit(self, err: BaseException) -> str:
        """A commitlog sync/write failure (CommitLog._record_sync_failure
        funnels here)."""
        from ..service.metrics import GLOBAL
        GLOBAL.incr("storage.commit_failures")
        policy = self.commit_policy
        self._record(err, "", "commit", policy)
        if policy == "die":
            self._die(err)
        elif policy == "stop":
            self._stop(err)
        elif policy == "stop_commit":
            if not self.commits_stopped:
                _log.error("commit_failure_policy=stop_commit: halting "
                           "writes after commitlog failure (%s); reads "
                           "continue", err)
                self.commits_stopped = True
                self._dump("stop_commit", err)
        return policy

    def _apply_disk(self, err, path, kind: str) -> str:
        policy = self.disk_policy
        self._record(err, path, kind, policy)
        if policy == "die":
            self._die(err)
        elif policy == "stop":
            self._stop(err)
        return policy

    def _record(self, err, path, kind, policy) -> None:
        with self._lock:
            self.errors.append({"kind": kind, "policy": policy,
                                "error": repr(err), "path": path,
                                "at": time.time()})
            del self.errors[:-self.RECENT_ERRORS]
        # failure-policy trigger on the diagnostic bus (no-op while the
        # knob is off): the event the flight-recorder bundle anchors on
        from ..service import diagnostics
        diagnostics.publish("failure.policy", kind=kind, policy=policy,
                            path=path, error=repr(err))

    def _dump(self, reason: str, err) -> None:
        """Flight-recorder bundle for a terminal policy transition;
        never raises (the failure being recorded wins)."""
        rec = self.flight_recorder
        if rec is not None:
            rec.trigger(f"failure_policy_{reason}", error=repr(err))

    def notify_quarantine(self, entry: dict) -> None:
        """An sstable left the live set for quarantine/: publish the
        diagnostic event and dump a black-box bundle (the reference's
        post-corruption forensics moment). Called by
        ColumnFamilyStore.quarantine_sstable after the move."""
        from ..service import diagnostics
        diagnostics.publish("sstable.quarantine",
                            keyspace=entry.get("keyspace", ""),
                            table=entry.get("table", ""),
                            generation=entry.get("generation"),
                            reason=str(entry.get("reason", ""))[:200],
                            path=entry.get("path", ""),
                            bytes=entry.get("bytes", 0))
        rec = self.flight_recorder
        if rec is not None:
            rec.trigger("sstable_quarantine",
                        generation=entry.get("generation"),
                        path=entry.get("path", ""))

    def _stop(self, err) -> None:
        with self._lock:
            if self.storage_stopped:
                return
            self.storage_stopped = True
            listeners = list(self._stop_listeners)
        _log.error("failure policy `stop`: taking the node out of "
                   "service after %r", err)
        self._dump("die" if self.dead else "stop", err)
        for cb in listeners:
            try:
                cb(err)
            except Exception:
                pass

    def _die(self, err) -> None:
        with self._lock:
            already = self.dead
            self.dead = True
            listeners = list(self._die_listeners)
        if not already:
            _log.critical("failure policy `die`: node is unusable "
                          "after %r", err)
            for cb in listeners:
                try:
                    cb(err)
                except Exception:
                    pass
        self._stop(err)

    # -------------------------------------------------------------- gates

    def check_can_write(self) -> None:
        if self.dead or self.storage_stopped:
            raise StorageStoppedError(
                "storage stopped by disk/commit failure policy")
        if self.commits_stopped:
            raise CommitLogStoppedError(
                "writes halted by commit_failure_policy=stop_commit")

    def check_can_read(self) -> None:
        if self.dead or self.storage_stopped:
            raise StorageStoppedError(
                "storage stopped by disk/commit failure policy")


# --------------------------------------------------------- quarantine --

def quarantine_descriptor_files(desc, reason: str = "") -> dict:
    """Move every component of one sstable generation into
    <table_dir>/quarantine/<version>-<generation>/ with a small
    manifest. Shared by ColumnFamilyStore.quarantine_sstable and the
    offline sstableverify --quarantine handoff. Open fds keep serving
    in-flight reads (the move only unlinks directory entries); restarts
    and reload_sstables can no longer resurrect the files because the
    TOC leaves the live directory. Returns the quarantine record."""
    import json
    import os
    qdir = os.path.join(desc.directory, "quarantine",
                        f"{desc.version}-{desc.generation}")
    os.makedirs(qdir, exist_ok=True)
    prefix = f"{desc.version}-{desc.generation}-"
    moved, total = [], 0
    for fn in sorted(os.listdir(desc.directory)):
        if not fn.startswith(prefix):
            continue
        src = os.path.join(desc.directory, fn)
        if not os.path.isfile(src):
            continue
        total += os.path.getsize(src)
        os.replace(src, os.path.join(qdir, fn))
        moved.append(fn)
    entry = {"generation": desc.generation, "version": desc.version,
             "reason": reason, "at": time.time(), "bytes": total,
             "files": moved, "path": qdir}
    with open(os.path.join(qdir, "quarantine.json"), "w") as f:
        json.dump(entry, f)
    return entry


def list_quarantined(directory: str) -> list[dict]:
    """Quarantine records under one table directory (startup rescan +
    the quarantined_sstables vtable after a restart)."""
    import json
    import os
    base = os.path.join(directory, "quarantine")
    out = []
    if not os.path.isdir(base):
        return out
    for d in sorted(os.listdir(base)):
        mpath = os.path.join(base, d, "quarantine.json")
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                continue
    return out
