"""Crash-safe SSTable lifecycle transactions.

Reference counterpart: db/lifecycle/LogTransaction.java:101 and
LifecycleTransaction.java:81 — an on-disk txn log records the ADDed and
REMOVEd sstables of a compaction/flush swap; on restart an incomplete log
rolls back (delete new files), a committed one rolls forward (delete old
files). The log lives next to the sstables it governs.

Log format (text, one record per line):
    ADD <generation>
    REMOVE <generation>
    COMMIT
"""
from __future__ import annotations

import os
import uuid as uuid_mod

from .sstable.format import Component, Descriptor

_PREFIX = "txn-"
_SUFFIX = ".log"


def _delete_sstable_files(directory: str, generation: int) -> None:
    for fn in os.listdir(directory):
        parts = fn.split("-")
        # <version>-<gen>-<Component> or tmp-<version>-<gen>-<Component>
        if len(parts) >= 3:
            idx = 1 if parts[0] != "tmp" else 2
            try:
                gen = int(parts[idx])
            except (ValueError, IndexError):
                continue
            if gen == generation:
                try:
                    os.remove(os.path.join(directory, fn))
                except FileNotFoundError:
                    pass


class LifecycleTransaction:
    """Tracks one swap: stage ADDs/REMOVEs, then commit (atomic-enough:
    the COMMIT line is the decision point; file deletions follow)."""

    def __init__(self, directory: str):
        self.directory = directory
        self.id = uuid_mod.uuid4().hex[:12]
        self.path = os.path.join(directory, f"{_PREFIX}{self.id}{_SUFFIX}")
        self._adds: list[int] = []
        self._removes: list[int] = []
        self._file = open(self.path, "w")
        self._done = False

    def track_new(self, generation: int) -> None:
        self._adds.append(generation)
        self._file.write(f"ADD {generation}\n")
        self._file.flush()
        os.fsync(self._file.fileno())

    def track_obsolete(self, generation: int) -> None:
        self._removes.append(generation)
        self._file.write(f"REMOVE {generation}\n")
        self._file.flush()
        os.fsync(self._file.fileno())

    def commit(self) -> None:
        """Decision point: the fsynced COMMIT record makes the swap
        permanent; the deletions after it are best-effort (a crash there
        leaves the committed log for replay_directory to roll forward)."""
        self._file.write("COMMIT\n")
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        self._done = True   # from here on, abort() must NOT roll back
        try:
            for gen in self._removes:
                _delete_sstable_files(self.directory, gen)
            os.remove(self.path)
        except OSError:
            pass  # replay_directory finishes the roll-forward

    def abort(self) -> None:
        if self._done:
            return  # already committed: rolling back would lose data
        self._file.close()
        for gen in self._adds:
            _delete_sstable_files(self.directory, gen)
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass
        self._done = True


def replay_directory(directory: str) -> None:
    """Startup recovery: finish or roll back interrupted transactions
    (LogTransaction + LogAwareFileLister semantics). Also sweeps orphaned
    tmp- files from crashed writers."""
    if not os.path.isdir(directory):
        return
    for fn in list(os.listdir(directory)):
        if not (fn.startswith(_PREFIX) and fn.endswith(_SUFFIX)):
            continue
        path = os.path.join(directory, fn)
        with open(path) as f:
            lines = [l.strip() for l in f if l.strip()]
        committed = "COMMIT" in lines
        adds = [int(l.split()[1]) for l in lines if l.startswith("ADD")]
        removes = [int(l.split()[1]) for l in lines if l.startswith("REMOVE")]
        if committed:
            for gen in removes:     # roll forward
                _delete_sstable_files(directory, gen)
        else:
            for gen in adds:        # roll back
                _delete_sstable_files(directory, gen)
        os.remove(path)
    for fn in list(os.listdir(directory)):
        if fn.startswith("tmp-") or fn.endswith(".stream"):
            # .stream: a stream receiver's staged component rename that
            # never happened (crash mid-landing)
            try:
                os.remove(os.path.join(directory, fn))
            except FileNotFoundError:
                pass
    # stream landings commit by writing the TOC last: a generation with
    # components but no TOC is a crashed landing — invisible to
    # Descriptor.discover, and swept here so it can't leak disk forever
    toc_gens, part_gens = set(), set()
    for fn in os.listdir(directory):
        parts = fn.split("-", 2)
        if len(parts) != 3 or not parts[1].isdigit() \
                or not parts[0].isalpha():
            continue
        gen = int(parts[1])
        part_gens.add(gen)
        if parts[2] == Component.TOC:
            toc_gens.add(gen)
    for gen in part_gens - toc_gens:
        _delete_sstable_files(directory, gen)
