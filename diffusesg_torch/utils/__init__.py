"""Device policy and weight carry-over."""
