"""The harness: registry, traffic generator, window, traces, check."""
