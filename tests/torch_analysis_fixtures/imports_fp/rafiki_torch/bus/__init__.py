"""Fixture bus package (reachability root; clean)."""
