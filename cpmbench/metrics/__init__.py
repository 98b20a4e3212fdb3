"""One reader per metric, found by its name."""
