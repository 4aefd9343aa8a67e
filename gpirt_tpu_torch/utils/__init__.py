"""Data loading, response recoding and diagnostics."""
