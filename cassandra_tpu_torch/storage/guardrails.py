"""Guardrails: operator-configured limits and warnings.

Reference counterpart: db/guardrails/Guardrails.java — thresholds that
warn or fail operations before they hurt the node (tables per keyspace,
batch size, tombstones per read, partition size ...).
"""
from __future__ import annotations

from dataclasses import dataclass, field


class GuardrailViolation(Exception):
    pass


@dataclass
class Guardrails:
    tables_warn_threshold: int = 150
    tables_fail_threshold: int = 500
    keyspaces_warn_threshold: int = 40
    keyspaces_fail_threshold: int = 150
    batch_statements_warn: int = 50
    batch_statements_fail: int = 500
    tombstones_warn_per_read: int = 1000
    tombstones_fail_per_read: int = 100_000
    collection_size_warn_bytes: int = 5 * 1024 * 1024
    collection_size_fail_bytes: int = 0          # 0 = disabled
    items_per_collection_warn: int = 2000
    items_per_collection_fail: int = 0
    column_value_size_warn_bytes: int = 0
    column_value_size_fail_bytes: int = 0
    columns_per_table_warn: int = 100
    columns_per_table_fail: int = 500
    fields_per_udt_warn: int = 30
    fields_per_udt_fail: int = 100
    secondary_indexes_per_table_warn: int = 3
    secondary_indexes_per_table_fail: int = 10
    materialized_views_per_table_warn: int = 3
    materialized_views_per_table_fail: int = 10
    page_size_warn: int = 5000
    page_size_fail: int = 0
    in_select_cartesian_fail: int = 100
    vector_dimensions_warn: int = 2048
    vector_dimensions_fail: int = 8192
    minimum_replication_factor_warn: int = 0
    minimum_replication_factor_fail: int = 0
    allow_filtering_enabled: bool = True
    drop_truncate_table_enabled: bool = True
    warnings: list = field(default_factory=list)

    @classmethod
    def from_config(cls, overrides: dict | None) -> "Guardrails":
        """Build from the config `guardrails:` block; unknown keys AND
        mis-typed values fail startup (GuardrailsOptions validation)."""
        import dataclasses as _dc

        from ..config import ConfigError
        overrides = overrides or {}
        fields = {f.name: f for f in _dc.fields(cls) if f.name != "warnings"}
        bad = set(overrides) - set(fields)
        if bad:
            raise ConfigError(f"unknown guardrail keys: {sorted(bad)}")
        coerced = {}
        for k, v in overrides.items():
            want = fields[k].type
            if want in ("int", int):
                if isinstance(v, bool) or not isinstance(v, int):
                    raise ConfigError(f"guardrail {k}: expected int, "
                                      f"got {v!r}")
            elif want in ("bool", bool) and not isinstance(v, bool):
                raise ConfigError(f"guardrail {k}: expected bool, "
                                  f"got {v!r}")
            coerced[k] = v
        return cls(**coerced)

    def _threshold(self, value: int, warn: int, fail: int,
                   what: str) -> None:
        """Shared warn/fail ladder (db/guardrails/Threshold.java): a
        0 threshold disables that side."""
        if fail and value > fail:
            raise GuardrailViolation(f"{what}: {value} > fail "
                                     f"threshold {fail}")
        if warn and value > warn:
            self._warn(f"{what}: {value} above warn threshold {warn}")

    def _warn(self, msg: str) -> None:
        self.warnings.append(msg)
        if len(self.warnings) > 100:
            self.warnings.pop(0)

    def check_table_count(self, n: int) -> None:
        if n >= self.tables_fail_threshold:
            raise GuardrailViolation(
                f"too many tables ({n} >= {self.tables_fail_threshold})")
        if n >= self.tables_warn_threshold:
            self._warn(f"table count {n} above warn threshold")

    def check_batch_size(self, n: int) -> None:
        if n > self.batch_statements_fail:
            raise GuardrailViolation(
                f"batch with {n} statements (fail threshold "
                f"{self.batch_statements_fail})")
        if n > self.batch_statements_warn:
            self._warn(f"batch with {n} statements above warn threshold")

    def check_tombstones(self, n: int, where: str) -> None:
        if n > self.tombstones_fail_per_read:
            raise GuardrailViolation(
                f"read scanned {n} tombstones in {where} "
                "(TombstoneOverwhelmingException role)")
        if n > self.tombstones_warn_per_read:
            self._warn(f"read scanned {n} tombstones in {where}")

    def check_in_cartesian(self, n: int) -> None:
        if n > self.in_select_cartesian_fail:
            raise GuardrailViolation(
                f"IN restriction expands to {n} partitions")

    def check_keyspace_count(self, n: int) -> None:
        self._threshold(n, self.keyspaces_warn_threshold,
                        self.keyspaces_fail_threshold, "keyspace count")

    def check_columns_per_table(self, n: int, table: str) -> None:
        self._threshold(n, self.columns_per_table_warn,
                        self.columns_per_table_fail,
                        f"columns in {table}")

    def check_fields_per_udt(self, n: int, name: str) -> None:
        self._threshold(n, self.fields_per_udt_warn,
                        self.fields_per_udt_fail,
                        f"fields in UDT {name}")

    def check_secondary_indexes(self, n: int, table: str) -> None:
        self._threshold(n, self.secondary_indexes_per_table_warn,
                        self.secondary_indexes_per_table_fail,
                        f"secondary indexes on {table}")

    def check_materialized_views(self, n: int, table: str) -> None:
        self._threshold(n, self.materialized_views_per_table_warn,
                        self.materialized_views_per_table_fail,
                        f"materialized views on {table}")

    def check_page_size(self, n: int) -> None:
        self._threshold(n, self.page_size_warn, self.page_size_fail,
                        "page size")

    def check_collection_size(self, nbytes: int, column: str) -> None:
        self._threshold(nbytes, self.collection_size_warn_bytes,
                        self.collection_size_fail_bytes,
                        f"collection {column} bytes")

    def check_items_per_collection(self, n: int, column: str) -> None:
        self._threshold(n, self.items_per_collection_warn,
                        self.items_per_collection_fail,
                        f"items in collection {column}")

    def check_column_value_size(self, nbytes: int, column: str) -> None:
        self._threshold(nbytes, self.column_value_size_warn_bytes,
                        self.column_value_size_fail_bytes,
                        f"value size of {column}")

    def check_vector_dimensions(self, dims: int, column: str) -> None:
        self._threshold(dims, self.vector_dimensions_warn,
                        self.vector_dimensions_fail,
                        f"vector dimensions of {column}")

    def check_replication_factor(self, rf: int, keyspace: str) -> None:
        """Minimum-RF guardrail (Guardrails.minimumReplicationFactor):
        fails a CREATE/ALTER KEYSPACE whose RF is below the floor."""
        if self.minimum_replication_factor_fail and \
                rf < self.minimum_replication_factor_fail:
            raise GuardrailViolation(
                f"replication factor {rf} of {keyspace} below minimum "
                f"{self.minimum_replication_factor_fail}")
        if self.minimum_replication_factor_warn and \
                rf < self.minimum_replication_factor_warn:
            self._warn(f"replication factor {rf} of {keyspace} below "
                       f"warn floor")

    def check_allow_filtering(self) -> None:
        if not self.allow_filtering_enabled:
            raise GuardrailViolation(
                "ALLOW FILTERING is disabled by the allow_filtering "
                "guardrail")

    def check_drop_truncate(self, what: str) -> None:
        if not self.drop_truncate_table_enabled:
            raise GuardrailViolation(
                f"{what} is disabled by the drop_truncate_table "
                f"guardrail")
