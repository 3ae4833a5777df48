"""The port's counterpart of tests/test_materialized_views.py: the same
assertions on cassandra_tpu_torch, every engine on the CPU (device="cpu").

Materialized views: DDL, derived writes, key-change moves, deletes,
backfill, restart (db/view/ViewUpdateGenerator, schema/ViewMetadata)."""
import pytest

from cassandra_tpu_torch.cql import Session
from cassandra_tpu_torch.schema import Schema
from cassandra_tpu_torch.storage.engine import StorageEngine
from torch_tmp import tmp_path  # noqa: F401


@pytest.fixture
def tmp_data(tmp_path):
    return str(tmp_path / "data")


@pytest.fixture
def engine(tmp_data):
    eng = StorageEngine(tmp_data, Schema(), commitlog_sync="batch",
                        device="cpu")
    yield eng
    eng.close()


@pytest.fixture
def session(engine):
    s = Session(engine)
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE ks")
    s.execute("CREATE TABLE users (id int PRIMARY KEY, city text, "
              "age int)")
    s.execute("CREATE MATERIALIZED VIEW users_by_city AS "
              "SELECT * FROM users WHERE city IS NOT NULL "
              "AND id IS NOT NULL PRIMARY KEY ((city), id)")
    return s


def test_view_reflects_inserts(session):
    session.execute("INSERT INTO users (id, city, age) VALUES "
                    "(1, 'paris', 30)")
    session.execute("INSERT INTO users (id, city, age) VALUES "
                    "(2, 'paris', 40)")
    session.execute("INSERT INTO users (id, city, age) VALUES "
                    "(3, 'oslo', 50)")
    rs = session.execute(
        "SELECT id, age FROM users_by_city WHERE city = 'paris'")
    assert sorted(rs.rows) == [(1, 30), (2, 40)]


def test_view_key_change_moves_row(session):
    session.execute("INSERT INTO users (id, city, age) VALUES "
                    "(7, 'rome', 20)")
    session.execute("UPDATE users SET city = 'lima' WHERE id = 7")
    assert session.execute(
        "SELECT id FROM users_by_city WHERE city = 'rome'").rows == []
    assert session.execute(
        "SELECT id, age FROM users_by_city WHERE city = 'lima'").rows \
        == [(7, 20)]


def test_view_row_follows_base_delete(session):
    session.execute("INSERT INTO users (id, city) VALUES (9, 'kyiv')")
    session.execute("DELETE FROM users WHERE id = 9")
    assert session.execute(
        "SELECT id FROM users_by_city WHERE city = 'kyiv'").rows == []


def test_view_null_key_excluded(session):
    session.execute("INSERT INTO users (id, age) VALUES (11, 60)")
    rs = session.execute("SELECT city, id FROM users_by_city")
    assert all(r[1] != 11 for r in rs.rows)
    session.execute("UPDATE users SET city = 'bern' WHERE id = 11")
    assert session.execute(
        "SELECT id FROM users_by_city WHERE city = 'bern'").rows == [(11,)]


def test_view_backfills_existing_data(session):
    for i in range(20, 25):
        session.execute(
            f"INSERT INTO users (id, city, age) VALUES ({i}, 'baku', 1)")
    session.execute("CREATE MATERIALIZED VIEW users_by_age AS "
                    "SELECT * FROM users WHERE age IS NOT NULL AND "
                    "id IS NOT NULL PRIMARY KEY ((age), id)")
    rs = session.execute("SELECT id FROM users_by_age WHERE age = 1")
    assert sorted(r[0] for r in rs.rows) == [20, 21, 22, 23, 24]


def test_view_write_rejected_and_drop(session):
    with pytest.raises(Exception, match="materialized view"):
        session.execute("INSERT INTO users_by_city (city, id) VALUES "
                        "('x', 1)")
    with pytest.raises(Exception, match="depend"):
        session.execute("DROP TABLE users")
    session.execute("DROP MATERIALIZED VIEW users_by_city")
    session.execute("DROP TABLE users")   # now allowed


def test_view_survives_restart(tmp_data, engine, session):
    session.execute("INSERT INTO users (id, city) VALUES (1, 'lviv')")
    engine.close()
    eng2 = StorageEngine(tmp_data, Schema(), commitlog_sync="batch",
                         device="cpu")
    try:
        s2 = Session(eng2)
        s2.keyspace = "ks"
        assert s2.execute("SELECT id FROM users_by_city "
                          "WHERE city = 'lviv'").rows == [(1,)]
        s2.execute("INSERT INTO users (id, city) VALUES (2, 'lviv')")
        assert sorted(s2.execute(
            "SELECT id FROM users_by_city WHERE city = 'lviv'").rows) \
            == [(1,), (2,)]
    finally:
        eng2.close()


def test_view_across_cluster(tmp_path):
    from cassandra_tpu_torch.cluster.node import LocalCluster
    from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
    c = LocalCluster(3, str(tmp_path), rf=3, device="cpu")
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        s.execute("USE ks")
        s.execute("CREATE TABLE ev (id int PRIMARY KEY, kind text)")
        s.execute("CREATE MATERIALIZED VIEW ev_by_kind AS SELECT * FROM ev "
                  "WHERE kind IS NOT NULL AND id IS NOT NULL "
                  "PRIMARY KEY ((kind), id)")
        c.node(1).default_cl = ConsistencyLevel.QUORUM
        for i in range(10):
            s.execute(f"INSERT INTO ev (id, kind) VALUES ({i}, "
                      f"'k{i % 2}')")
        s2 = c.session(2)
        s2.keyspace = "ks"
        c.node(2).default_cl = ConsistencyLevel.QUORUM  # ONE could read a
        # replica outside the write quorum — legitimate CL semantics
        rs = s2.execute("SELECT id FROM ev_by_kind WHERE kind = 'k1'")
        assert sorted(r[0] for r in rs.rows) == [1, 3, 5, 7, 9]
    finally:
        c.shutdown()


def test_view_nulled_column_and_null_backfill(session):
    session.execute("INSERT INTO users (id, city, age) VALUES "
                    "(31, 'graz', 5)")
    session.execute("UPDATE users SET age = null WHERE id = 31")
    rs = session.execute("SELECT id, age FROM users_by_city "
                         "WHERE city = 'graz'")
    assert rs.rows == [(31, None)]
    # backfill over a row whose view key column is null must not crash
    session.execute("INSERT INTO users (id, age) VALUES (32, 9)")
    session.execute("CREATE MATERIALIZED VIEW by_city2 AS SELECT * "
                    "FROM users WHERE city IS NOT NULL AND id IS NOT "
                    "NULL PRIMARY KEY ((city), id)")
    rs = session.execute("SELECT id FROM by_city2 WHERE city = 'graz'")
    assert rs.rows == [(31,)]


def test_view_ttl_propagates(session):
    import time
    session.execute("INSERT INTO users (id, city) VALUES (41, 'turin') "
                    "USING TTL 1")
    assert session.execute(
        "SELECT id FROM users_by_city WHERE city = 'turin'").rows \
        == [(41,)]
    time.sleep(1.5)
    assert session.execute(
        "SELECT id FROM users_by_city WHERE city = 'turin'").rows == []


def test_view_timestamped_delete_shadows(session):
    session.execute("INSERT INTO users (id, city) VALUES (42, 'nice') "
                    "USING TIMESTAMP 100")
    session.execute("DELETE FROM users USING TIMESTAMP 200 WHERE id = 42")
    assert session.execute(
        "SELECT id FROM users_by_city WHERE city = 'nice'").rows == []


def test_view_logged_batch(session):
    session.execute("INSERT INTO users (id, city, age) VALUES "
                    "(51, 'rome', 99)")
    session.execute("BEGIN BATCH "
                    "UPDATE users SET age = 5 WHERE id = 51; "
                    "UPDATE users SET city = 'rome' WHERE id = 51; "
                    "APPLY BATCH;")
    rs = session.execute("SELECT id, age FROM users_by_city "
                         "WHERE city = 'rome'")
    assert rs.rows == [(51, 5)]
