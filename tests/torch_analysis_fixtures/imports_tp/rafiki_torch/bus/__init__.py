"""Fixture bus package (the RTA602 reachability root)."""
