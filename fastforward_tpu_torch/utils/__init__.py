"""Utilities (tracing).  Indexing, evaluation and serving helpers are
ROADMAP Queue 1 item 11."""
