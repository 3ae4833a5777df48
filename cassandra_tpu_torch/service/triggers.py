"""Triggers: coordinator-side mutation augmentation.

Reference counterpart: triggers/TriggerExecutor.java + ITrigger.java
(CREATE TRIGGER ... USING 'class'). In the reference, trigger classes
load from jars the OPERATOR already placed in conf/triggers — DDL can
only NAME installed code, never ship it. The same trust model applies
here: a trigger source is '<file>:<function>' resolved strictly inside
the node's <data_dir>/triggers/ directory, and <file>.py must already
exist there when CREATE TRIGGER runs.

The function's contract (ITrigger.augment analog):

    def my_trigger(table, mutation, backend) -> iterable[Mutation] | None

It runs on the COORDINATOR while the statement executes, so augmented
mutations get their own replication, hints and consistency like any
write (TriggerExecutor.execute augments before StorageProxy.mutate).
Augmented mutations do NOT re-trigger and skip view derivation — the
reference's single-augmentation-pass semantics.
"""
from __future__ import annotations

import importlib.util
import os

from ..storage.mutation import Mutation


class TriggerError(ValueError):
    pass


class TriggerManager:
    def __init__(self, directory: str):
        self.directory = directory
        # (keyspace, table) -> {trigger_name: source}
        self.triggers: dict[tuple, dict[str, str]] = {}
        self._fns: dict[tuple, object] = {}

    # ----------------------------------------------------------- loading --

    def _load_fn(self, source: str):
        try:
            fname, func = source.split(":")
        except ValueError:
            raise TriggerError(
                "trigger USING must be '<file>:<function>' (a .py file "
                f"in {self.directory})")
        if fname != os.path.basename(fname) or not fname.isidentifier():
            raise TriggerError(f"bad trigger file name {fname!r}")
        path = os.path.join(self.directory, fname + ".py")
        if not os.path.exists(path):
            raise TriggerError(
                f"trigger file {path} not installed — place it there "
                "first (conf/triggers role); DDL cannot ship code")
        spec = importlib.util.spec_from_file_location(
            f"ctpu_trigger_{fname}", path)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except Exception as e:
            raise TriggerError(f"trigger file {fname}.py failed to "
                               f"load: {e!r}")
        fn = getattr(mod, func, None)
        if not callable(fn):
            raise TriggerError(f"{fname}.py has no function {func!r}")
        return fn

    # -------------------------------------------------------------- DDL --

    def create(self, keyspace: str, table: str, name: str,
               source: str, if_not_exists: bool = False) -> None:
        key = (keyspace, table)
        if name in self.triggers.get(key, {}):
            if if_not_exists:
                return
            raise TriggerError(f"trigger {name} exists on "
                               f"{keyspace}.{table}")
        fn = self._load_fn(source)          # validates at CREATE time
        self.triggers.setdefault(key, {})[name] = source
        self._fns[(keyspace, table, name)] = fn

    def drop(self, keyspace: str, table: str, name: str,
             if_exists: bool = False) -> None:
        key = (keyspace, table)
        if name not in self.triggers.get(key, {}):
            if if_exists:
                return
            raise TriggerError(f"no trigger {name} on {keyspace}.{table}")
        del self.triggers[key][name]
        self._fns.pop((keyspace, table, name), None)

    def drop_table(self, keyspace: str, table: str) -> None:
        for name in self.triggers.pop((keyspace, table), {}):
            self._fns.pop((keyspace, table, name), None)

    # ---------------------------------------------------------- runtime --

    def augment(self, t, mutation: Mutation, backend) -> list[Mutation]:
        """All extra mutations the table's triggers produce for this
        base mutation. A trigger raising aborts the statement — the
        reference fails the write when augmentation fails."""
        key = (t.keyspace, t.name)
        named = self.triggers.get(key)
        if not named:
            return []
        out: list[Mutation] = []
        for name in named:
            fkey = (t.keyspace, t.name, name)
            fn = self._fns.get(fkey)
            if fn is None:
                # compiled-fn cache cleared (nodetool reloadtriggers):
                # re-import the trigger file lazily
                fn = self._load_fn(named[name])
                self._fns[fkey] = fn
            try:
                extra = fn(t, mutation, backend)
            except Exception as e:
                raise TriggerError(
                    f"trigger {name} on {t.keyspace}.{t.name} "
                    f"failed: {e!r}")
            for em in extra or []:
                if not isinstance(em, Mutation):
                    raise TriggerError(
                        f"trigger {name} returned {type(em).__name__}, "
                        "expected Mutation")
                out.append(em)
        return out

    # ------------------------------------------------------------ serde --

    def to_list(self) -> list[dict]:
        return [{"keyspace": ks, "table": tb, "name": nm, "using": src}
                for (ks, tb), named in self.triggers.items()
                for nm, src in named.items()]

    def load_list(self, items: list[dict]) -> None:
        for d in items:
            try:
                self.create(d["keyspace"], d["table"], d["name"],
                            d["using"], if_not_exists=True)
            except TriggerError as e:
                # file removed since the trigger was created: keep the
                # trigger registered but BROKEN, so writes on this node
                # fail visibly instead of silently skipping augmentation
                # (the reference fails writes on a missing class too);
                # DROP TRIGGER clears it
                key = (d["keyspace"], d["table"])
                if d["name"] not in self.triggers.get(key, {}):
                    self.triggers.setdefault(key, {})[d["name"]] \
                        = d["using"]
                    def broken(_t, _m, _b, _e=e, _n=d["name"]):
                        raise TriggerError(
                            f"trigger {_n} unusable on this node: {_e}")

                    self._fns[(d["keyspace"], d["table"], d["name"])] \
                        = broken
