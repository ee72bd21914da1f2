"""The scheduler store's SQL backend selection (the JAX package's
ingest/sqladapter.py, for SQLite only).

The JAX package writes the scheduler store's SQL once in the SQLite dialect
and adapts it to an external PostgreSQL through its wire driver
(ingest/pgwire.py) when the store's path is a postgres:// URL.  The port's
store runs on SQLite; the statement translation, the wire driver and its
fake server come in the next slice of the port, and until then a Postgres
URL raises NotImplementedError here, before anything connects.
"""

from __future__ import annotations


class PgAdapter:
    """The sqlite3.Connection surface over an external PostgreSQL: not in
    the port yet."""

    def __init__(self, dsn: str, session_sql: tuple = ()):
        raise NotImplementedError(
            "the PostgreSQL scheduler DB (ingest/pgwire.py and sqladapter's "
            "Postgres branch) comes in the next slice of the port; use a "
            "sqlite path"
        )


def is_postgres_url(path: str) -> bool:
    return path.startswith(("postgres://", "postgresql://"))
