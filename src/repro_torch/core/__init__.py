"""Memory, ingest stages, query plans, sessions and the Venus facade."""
