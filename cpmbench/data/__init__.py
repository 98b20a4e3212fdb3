"""Seeded inputs of the benchmark, made on the device: one module a volume
kind, ``<kind>.py``, found by a configuration's ``volume.kind``. Each has
``make(spec, generator, device)``, which makes the (dim, dim, dim)
float32 volume of the configuration's ``volume`` entry ``spec`` from
``generator``, a ``torch.Generator`` on ``device`` seeded with the run's
seed, in a few large calls."""
